"""TFQMR: transpose-free quasi-minimal residual (Freund '93).

Counterpart of ``trilinos_tpu/solvers/tfqmr.py`` (Belos::TFQMRIter): two
operator applies per outer step (one per half-step), no transpose apply.
The loop tests the quasi-residual τ, which can underestimate the true
residual by up to √(2k+2), so the result is certified by an explicit
residual and resumed with a tightened threshold when τ undershot
(``certified_solve``).
"""
from __future__ import annotations

import torch

from ..ops.blas import local_dot
from ..parallel.comm import Comm, SerialComm
from .base import (Operator, SolveResult, bcast_cols, certified_solve,
                   identity_prec, rhs_norm_scale, safe_divide)


def tfqmr(op: Operator, b: torch.Tensor, x0: torch.Tensor | None = None, *,
          prec: Operator | None = None, rtol: float = 1e-8,
          atol: float = 0.0, maxiter: int = 1000,
          comm: Comm | None = None) -> SolveResult:
    comm = comm or SerialComm()
    M = prec or identity_prec
    x = torch.zeros_like(b) if x0 is None else x0

    def amul(v):
        return op(M(v))

    def dot(u, v):
        return comm.psum(local_dot(u, v))

    bb = dot(b, b)
    tol = rhs_norm_scale(torch.sqrt(bb), rtol, atol)

    def solve_from(x, tol2, k):
        k0 = k
        loop_tol = torch.sqrt(tol2)  # τ is a norm, not a squared norm
        # solve A M du = r0, then x = x0 + M du (right preconditioning
        # with an arbitrary x0)
        r0 = b - op(x)
        du = torch.zeros_like(b)
        rr0 = dot(r0, r0)
        tau = torch.sqrt(rr0)
        rtilde = w = u = r0
        v = amul(u)
        d = torch.zeros_like(b)
        rho = rr0
        theta = torch.zeros_like(tau)
        eta = torch.zeros_like(tau)
        alpha = torch.zeros_like(tau)
        one = torch.ones_like(tau)
        while k < maxiter and bool((tau > loop_tol).any()):
            active = tau > loop_tol
            zero = torch.zeros_like(tau)
            # parity is per pass: its first step computes α
            even = (k - k0) % 2 == 0
            if even:
                alpha = torch.where(active, safe_divide(rho, dot(rtilde, v)),
                                    zero)
            au = amul(u)
            w = w - bcast_cols(alpha, au)
            d = u + bcast_cols(torch.where(
                alpha != 0, safe_divide(theta * theta, alpha) * eta, zero), d)
            theta_new = safe_divide(torch.sqrt(dot(w, w)), tau)
            c = safe_divide(one, torch.sqrt(1.0 + theta_new * theta_new))
            tau_new = tau * theta_new * c
            eta_new = c * c * alpha
            du = du + bcast_cols(torch.where(active, eta_new, zero), d)
            if even:
                u = u - bcast_cols(alpha, v)  # second half-step's u
            else:
                rho_new = dot(rtilde, w)
                beta = safe_divide(rho_new, rho)
                u = w + bcast_cols(beta, u)
                v = amul(u) + bcast_cols(beta, au + bcast_cols(beta, v))
                rho = rho_new
            tau = torch.where(active, tau_new, tau)
            theta = torch.where(active, theta_new, theta)
            eta = torch.where(active, eta_new, eta)
            k += 1
        return x + M(du), k

    x, k, resnorm, conv = certified_solve(solve_from, op, b, x, tol, maxiter,
                                          comm)
    return SolveResult(x=x, iters=k, resnorm=resnorm, converged=conv)
