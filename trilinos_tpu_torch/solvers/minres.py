"""MINRES: minimal residual for symmetric (possibly indefinite) systems.

Counterpart of ``trilinos_tpu/solvers/minres.py`` (Belos::MinresIter):
the Lanczos three-term recurrence with Givens rotations on the fly; per
iteration one operator apply, one preconditioner apply and two
reductions. The preconditioner must be SPD (applied in the M-inner
product, as in the reference).
"""
from __future__ import annotations

import torch

from ..ops.blas import local_dot
from ..parallel.comm import Comm, SerialComm
from .base import (Operator, SolveResult, bcast_cols, certified_solve,
                   identity_prec, rhs_norm_scale, safe_divide)


def minres(op: Operator, b: torch.Tensor, x0: torch.Tensor | None = None, *,
           prec: Operator | None = None, rtol: float = 1e-8,
           atol: float = 0.0, maxiter: int = 1000,
           comm: Comm | None = None) -> SolveResult:
    comm = comm or SerialComm()
    M = prec or identity_prec
    x = torch.zeros_like(b) if x0 is None else x0
    bb = comm.psum(local_dot(b, b))
    tol = rhs_norm_scale(torch.sqrt(bb), rtol, atol)

    def solve_from(x, tol2, k):
        return _minres_loop(op, M, b, x, tol2, maxiter, comm, k)

    x, k, resnorm, conv = certified_solve(solve_from, op, b, x, tol, maxiter,
                                          comm)
    return SolveResult(x=x, iters=k, resnorm=resnorm, converged=conv)


def _minres_loop(op, M, b, x, tol2, maxiter, comm, k):
    loop_tol = torch.sqrt(tol2)  # phibar is a norm, not a squared norm
    r1 = b - op(x)
    y = M(r1)
    beta = torch.sqrt(torch.clamp(comm.psum(local_dot(r1, y)), min=0.0))
    zero = torch.zeros_like(beta)
    one = torch.ones_like(beta)
    r2 = r1
    w = torch.zeros_like(b)
    w2 = torch.zeros_like(b)
    phibar = beta
    oldb = dbar = epsln = sn = zero
    cs = -one
    tiny = torch.finfo(beta.dtype).tiny
    first = True
    while k < maxiter and bool((phibar > loop_tol).any()):
        active = phibar > loop_tol
        v = bcast_cols(safe_divide(one, beta), y)
        yv = op(v)
        alfa = comm.psum(local_dot(v, yv))
        yv = yv - bcast_cols(safe_divide(alfa, beta), r2)
        if not first:
            yv = yv - bcast_cols(safe_divide(beta, oldb), r1)
        r1, r2 = r2, yv
        y = M(r2)
        beta_new = torch.sqrt(torch.clamp(comm.psum(local_dot(r2, y)),
                                          min=0.0))
        # Givens update of the tridiagonal factorization
        oldeps = epsln
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln = sn * beta_new
        dbar = -cs * beta_new
        gamma = torch.clamp(torch.sqrt(gbar * gbar + beta_new * beta_new),
                            min=tiny)
        cs = safe_divide(gbar, gamma)
        sn = safe_divide(beta_new, gamma)
        phi = cs * phibar
        phibar_new = sn * phibar
        w1, w2 = w2, w
        w = bcast_cols(safe_divide(one, gamma), v - bcast_cols(oldeps, w1)
                       - bcast_cols(delta, w2))
        x = x + bcast_cols(torch.where(active, phi, zero), w)
        phibar = torch.where(active, phibar_new, phibar)
        oldb, beta = beta, beta_new
        first = False
        k += 1
    return x, k
