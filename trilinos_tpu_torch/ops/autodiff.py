"""Derivative rules of the kernel wrappers.

The JAX package differentiates through its sparse applies for free: JAX
traces the XLA apply, or the Pallas call's reference. The port's wrappers
launch a hand-written kernel through raw data pointers, which autograd
cannot see into: under ``torch.func.jvp`` the output would carry no
tangent. So every stencil, DIA and BDIA apply that can be differentiated
(:func:`differentiating`) is one call of :class:`LinearApply`, an
``autograd.Function`` in the functorch form (``forward`` without ``ctx``,
``setup_context``, ``jvp``, ``backward``), on both devices:

* the matrix is a constant of the Function (nothing differentiates its
  values; :func:`linear_apply` refuses values that require grad);
* ``jvp``: the same apply on the tangent, one more kernel launch on the
  card;
* ``backward``: the transpose apply, reached by calling the Function again
  with the forward and transpose exchanged, so the backward is itself
  differentiable (forward-over-reverse Hessian-vector products go through
  it).

On the CPU the forward runs the wrapper's plain version, so the CPU tests
use these rules, not torch's own differentiation of the plain code.
``LinearApply.jvp_calls`` and ``LinearApply.backward_calls`` count the
rules' calls.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.autograd.forward_ad as fwAD

Apply = Callable[[object, torch.Tensor], torch.Tensor]


class LinearApply(torch.autograd.Function):
    """y = fwd(a, x) for a linear x ↦ A·x with A constant; ``fwd_t`` is
    x ↦ Aᵀ·x."""

    jvp_calls = 0
    backward_calls = 0

    @staticmethod
    def forward(fwd: Apply, fwd_t: Apply, a, x: torch.Tensor):
        return fwd(a, x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.fwd, ctx.fwd_t, ctx.a = inputs[:3]

    @staticmethod
    def jvp(ctx, _fwd_t, _fwd_tt, _a_t, x_t):
        LinearApply.jvp_calls += 1
        return LinearApply.apply(ctx.fwd, ctx.fwd_t, ctx.a, x_t.contiguous())

    @staticmethod
    def backward(ctx, g):
        LinearApply.backward_calls += 1
        return None, None, None, LinearApply.apply(ctx.fwd_t, ctx.fwd, ctx.a,
                                                   g.contiguous())


def differentiating(x: torch.Tensor) -> bool:
    """Whether an apply to x can be differentiated: a ``torch.func``
    transform is active, a forward-mode dual level is open, or x requires
    grad under grad mode."""
    return (torch._C._are_functorch_transforms_active()
            or fwAD._current_level >= 0
            or (x.requires_grad and torch.is_grad_enabled()))


def linear_apply(fwd: Apply, fwd_t: Apply, a, x: torch.Tensor):
    """``fwd(a, x)`` through :class:`LinearApply` wherever it can be
    differentiated, else ``fwd(a, x)`` directly: the Function's bookkeeping
    adds host time to every call, which host-paced solves of 10⁵ applies
    feel. Raises if the matrix's stored values (``a.data``) require
    grad."""
    values = getattr(a, "data", None)
    if isinstance(values, torch.Tensor) and values.requires_grad:
        raise ValueError("the kernel wrappers differentiate in x only; the "
                         "matrix values must not require grad")
    if differentiating(x):
        return LinearApply.apply(fwd, fwd_t, a, x)
    return fwd(a, x)
