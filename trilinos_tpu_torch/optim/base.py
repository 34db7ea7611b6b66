"""Shared optimization infrastructure (ROL analogue).

Counterpart of ``trilinos_tpu/optim/base.py``. Reference anchors:
packages/rol/src/algorithm/ROL_Algorithm.hpp (the run loop: compute step
-> update -> status test), ROL_StatusTest.hpp (gtol/stol/maxit),
ROL_Objective.hpp (value/gradient/hessVec protocol).

Same shape as the ``nonlinear`` package: the outer loop runs on the host
(ROL's Algorithm::run is a host loop over abstract-vector ops too); value,
gradient and Hessian-vector products are torch calls on the iterate's
device. ROL's Objective asks users to implement ``gradient`` and
``hessVec`` by hand (or falls back to finite differences,
ROL_Objective_def.hpp); here ``torch.func.grad_and_value`` and
forward-over-reverse ``torch.func.jvp`` of ``torch.func.grad`` supply both
exactly, through the kernel wrappers' derivative rules where the objective
applies a stored or stencil matrix.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class OptimizeResult:
    x: torch.Tensor
    fval: float
    gnorm: float            # ||grad|| (projected grad for bounds)
    iters: int
    converged: bool
    inner_iters: int = 0    # truncated-CG / line-search evaluations


def _obj_fns(obj):
    """(value+grad, hessian-vector, value) of an objective.

    The objective may take extra arguments after x (``obj(x, *args)`` —
    e.g. the multiplier/penalty state of the augmented Lagrangian); the
    derivatives are in x only. ``val_grad`` returns (value, gradient)."""
    grad_value = torch.func.grad_and_value(obj)

    def val_grad(x, *args):
        g, f = grad_value(x, *args)
        return f, g

    def hvp(x, v, *args):
        return torch.func.jvp(lambda xx: torch.func.grad(obj)(xx, *args),
                              (x,), (v,))[1]

    return val_grad, hvp, obj
