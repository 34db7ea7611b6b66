"""LSQR (Golub–Kahan bidiagonalization) and fixed-point iteration.

Counterpart of ``trilinos_tpu/solvers/lsqr.py``: ``lsqr`` is the analogue
of Belos::LSQRIter/LSQRSolMgr and needs the transpose apply ``op_t``
(single RHS, as in the reference); ``fixed_point`` is the preconditioned
Richardson iteration of Belos::FixedPointIter.
"""
from __future__ import annotations

import torch

from ..ops.blas import local_dot
from ..parallel.comm import Comm, SerialComm, norm2
from .base import (Operator, SolveResult, identity_prec, rhs_norm_scale,
                   safe_divide)


def lsqr(op: Operator, op_t: Operator, b: torch.Tensor,
         x0: torch.Tensor | None = None, *, rtol: float = 1e-8,
         atol: float = 0.0, maxiter: int = 1000, damp: float = 0.0,
         comm: Comm | None = None) -> SolveResult:
    """min ‖b − A x‖ (with Tikhonov ``damp``); ``resnorm`` is the
    recurrence's |φ̄|, as in the reference. One host read an iteration."""
    comm = comm or SerialComm()
    x = torch.zeros_like(b) if x0 is None else x0
    u = b - op(x)
    beta = norm2(comm, u)
    u = safe_divide(u, beta)
    v = op_t(u)
    alpha = norm2(comm, v)
    v = safe_divide(v, alpha)
    w = v
    phibar = beta
    rhobar = alpha
    bnorm = norm2(comm, b)
    tol = rtol * torch.where(bnorm > 0, bnorm, torch.ones_like(bnorm)) + atol
    one = torch.ones_like(bnorm)
    k = 0
    while k < maxiter and bool(phibar.abs() > tol):
        u = op(v) - alpha * u
        beta = norm2(comm, u)
        u = safe_divide(u, beta)
        v = op_t(u) - beta * v
        alpha = norm2(comm, v)
        v = safe_divide(v, alpha)
        # the damping rotation first; cs1 carries rhobar's sign
        rhobar1 = torch.sqrt(rhobar * rhobar + damp * damp)
        cs1 = torch.where(rhobar1 != 0, rhobar / torch.where(
            rhobar1 != 0, rhobar1, one), one)
        phibar = cs1 * phibar
        # the main plane rotation
        rho = torch.sqrt(rhobar1 * rhobar1 + beta * beta)
        c = safe_divide(rhobar1, rho)
        s = safe_divide(beta, rho)
        theta = s * alpha
        rhobar = -c * alpha
        phi = c * phibar
        phibar = s * phibar
        x = x + safe_divide(phi, rho) * w
        w = v - safe_divide(theta, rho) * w
        k += 1
    return SolveResult(x=x, iters=k, resnorm=phibar.abs(),
                       converged=phibar.abs() <= tol)


def fixed_point(op: Operator, b: torch.Tensor,
                x0: torch.Tensor | None = None, *,
                prec: Operator | None = None, rtol: float = 1e-8,
                atol: float = 0.0, maxiter: int = 1000, omega: float = 1.0,
                comm: Comm | None = None) -> SolveResult:
    """Preconditioned Richardson iteration x ← x + ω M(b − A x)."""
    comm = comm or SerialComm()
    M = prec or identity_prec
    x = torch.zeros_like(b) if x0 is None else x0
    tol = rhs_norm_scale(torch.sqrt(comm.psum(local_dot(b, b))), rtol, atol)
    tol2 = tol * tol

    def rr(x):
        r = b - op(x)
        return comm.psum(local_dot(r, r))

    r2 = rr(x)
    k = 0
    while k < maxiter and bool((r2 > tol2).any()):
        x = x + omega * M(b - op(x))
        r2 = rr(x)
        k += 1
    return SolveResult(x=x, iters=k, resnorm=torch.sqrt(r2),
                       converged=r2 <= tol2)
