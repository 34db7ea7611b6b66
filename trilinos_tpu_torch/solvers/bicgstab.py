"""BiCGStab: stabilized bi-conjugate gradients.

Counterpart of ``trilinos_tpu/solvers/bicgstab.py`` (Belos::BiCGStabIter),
right-preconditioned; per iteration two operator applies, two
preconditioner applies and three reductions (ρ with the convergence norm,
⟨r̂, v⟩, and ⟨t, s⟩ with ⟨t, t⟩). Multivector RHS: per-column scalar
recurrences on shared batched applies (pseudo-block).
"""
from __future__ import annotations

import torch

from ..ops.blas import local_dot
from ..parallel.comm import Comm, SerialComm
from .base import (Operator, SolveResult, bcast_cols, certified_solve,
                   identity_prec, rhs_norm_scale, safe_divide)


def bicgstab(op: Operator, b: torch.Tensor, x0: torch.Tensor | None = None,
             *, prec: Operator | None = None, rtol: float = 1e-8,
             atol: float = 0.0, maxiter: int = 1000,
             comm: Comm | None = None) -> SolveResult:
    comm = comm or SerialComm()
    M = prec or identity_prec
    x = torch.zeros_like(b) if x0 is None else x0
    bb = comm.psum(local_dot(b, b))
    tol = rhs_norm_scale(torch.sqrt(bb), rtol, atol)

    def solve_from(x, tol2, k):
        r = b - op(x)
        rhat = r  # the shadow residual is the pass's r0 (Belos' default)
        d0 = comm.psum(torch.stack([local_dot(rhat, r), local_dot(r, r)]))
        rho, rr = d0[0], d0[1]
        p = r
        while k < maxiter and bool((rr > tol2).any()):
            active = rr > tol2
            zero = torch.zeros_like(rho)
            yv = M(p)
            v = op(yv)
            rhat_v = comm.psum(local_dot(rhat, v))
            alpha = torch.where(active, safe_divide(rho, rhat_v), zero)
            s_vec = r - bcast_cols(alpha, v)
            zs = M(s_vec)
            t = op(zs)
            dt = comm.psum(torch.stack([local_dot(t, s_vec),
                                        local_dot(t, t)]))
            omega = torch.where(active, safe_divide(dt[0], dt[1]), zero)
            x = x + bcast_cols(alpha, yv) + bcast_cols(omega, zs)
            r = s_vec - bcast_cols(omega, t)
            d = comm.psum(torch.stack([local_dot(rhat, r), local_dot(r, r)]))
            rho_new, rr_new = d[0], d[1]
            beta = torch.where(active, safe_divide(rho_new, rho)
                               * safe_divide(alpha, omega), zero)
            p = r + bcast_cols(beta, p - bcast_cols(omega, v))
            rho = torch.where(active, rho_new, rho)
            rr = torch.where(active, rr_new, rr)
            k += 1
        return x, k

    x, k, resnorm, conv = certified_solve(solve_from, op, b, x, tol, maxiter,
                                          comm)
    return SolveResult(x=x, iters=k, resnorm=resnorm, converged=conv)
