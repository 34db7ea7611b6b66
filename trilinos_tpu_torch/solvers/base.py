"""Shared solver infrastructure: result record, operator protocol, the
certified retry loop.

Counterpart of ``trilinos_tpu/solvers/base.py``. An operator is any
callable ``y = op(x)`` on (n_pad,) or (n_pad, k) tensors; reductions go
through a ``Comm``. JAX's ``lax.while_loop`` becomes a Python loop whose
condition reads one scalar from the device per pass.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..ops.blas import local_dot

Operator = Callable[[torch.Tensor], torch.Tensor]

MAX_TRIES = 4  # certified passes before a tolerance counts as unattainable
TIGHTEN = 0.0625  # factor on the squared loop threshold per retry pass


@dataclasses.dataclass
class SolveResult:
    """What a solve returns."""

    x: torch.Tensor
    iters: int  # iterations performed
    resnorm: torch.Tensor  # certified residual norm(s), per RHS column
    converged: torch.Tensor  # bool per RHS column
    # optional condition estimate of the preconditioned operator from the
    # solver's own recurrence; None unless requested
    condest: torch.Tensor | None = None
    # optional per-iteration implicit residual norms, NaN past the final
    # iteration (the StatusTestOutput trace as data); None unless requested
    history: torch.Tensor | None = None


def identity_prec(x: torch.Tensor) -> torch.Tensor:
    return x


def bcast_cols(scalars: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Broadcast per-column scalars onto a (n,) or (n, k) multivector."""
    if v.ndim == 1:
        return scalars * v
    return scalars[None, :] * v


def safe_divide(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num/den with 0 where den == 0 (guards frozen/converged columns)."""
    nz = den != 0
    return torch.where(nz, num / torch.where(nz, den, torch.ones_like(den)),
                       torch.zeros_like(num))


def rhs_norm_scale(bnorm: torch.Tensor, rtol, atol) -> torch.Tensor:
    """Threshold ||r|| <= rtol*||b|| + atol; a zero RHS scales by 1."""
    scale = torch.where(bnorm > 0, bnorm, torch.ones_like(bnorm))
    return rtol * scale + atol


def certified_solve(solve_from, op, b, x0, tol, maxiter, comm):
    """Run a solver loop, certify with an explicit residual, and when the
    recurrence undershoots (f32 drift), resume with a 16x tightened loop
    threshold until the certified residual passes, ``maxiter`` is spent, or
    ``MAX_TRIES`` passes have run (an unattainable tolerance then reports
    converged=False after bounded work).

    solve_from(x, tol2_loop, k0) -> (x, k) continues the iteration from x;
    k counts cumulative iterations. Returns (x, k, resnorm, converged).
    """
    tol2 = tol * tol
    t2 = tol2 * torch.ones_like(tol)
    rr = torch.full_like(t2, float("inf"))
    x, k, tries = x0, 0, 0
    while k < maxiter and tries < MAX_TRIES and bool((rr > tol2).any()):
        x, k = solve_from(x, t2, k)
        t2 = t2 * TIGHTEN
        r = b - op(x)
        rr = comm.psum(local_dot(r, r))
        tries += 1
    resnorm = torch.sqrt(rr)
    return x, k, resnorm, resnorm <= tol


def certify_residual(op: Operator, b: torch.Tensor, x: torch.Tensor, tol,
                     comm):
    """Explicit-residual certification: (resnorm_true, converged)."""
    r = b - op(x)
    resnorm = torch.sqrt(comm.psum(local_dot(r, r)))
    return resnorm, resnorm <= tol
