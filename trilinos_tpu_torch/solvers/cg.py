"""Preconditioned conjugate gradients.

Counterpart of ``cg`` in ``trilinos_tpu/solvers/cg.py`` (the analogue of
Belos::PseudoBlockCGIter): per iteration one operator apply, one
preconditioner apply and two reductions, the r·z and r·r dots sharing one
``psum``. Multivector RHS: reductions are columnwise and converged columns
are frozen by zeroing their step sizes.

The loop condition reads the squared residual on the host once per
iteration.
"""
from __future__ import annotations

import torch

from ..ops.blas import local_dot
from ..parallel.comm import Comm, SerialComm
from .base import (Operator, SolveResult, bcast_cols, certified_solve,
                   identity_prec, rhs_norm_scale, safe_divide)

_LATER = "is not ported yet (ROADMAP.md queue 1 item 2, cg options)"


def cg(op: Operator, b: torch.Tensor, x0: torch.Tensor | None = None, *,
       prec: Operator | None = None, rtol: float = 1e-8, atol: float = 0.0,
       maxiter: int = 1000, comm: Comm | None = None,
       condest_window: int = 0, stop=None, history: bool = False,
       compensated: bool = False) -> SolveResult:
    """Preconditioned CG certified by an explicit residual (see
    ``certified_solve``). ``condest_window``, ``stop``, ``history`` and
    ``compensated`` keep the JAX signature and raise until ported."""
    for name, val in (("condest_window", condest_window), ("stop", stop),
                      ("history", history), ("compensated", compensated)):
        if val:
            raise NotImplementedError(f"cg({name}=...) {_LATER}")
    comm = comm or SerialComm()
    M = prec or identity_prec
    x = torch.zeros_like(b) if x0 is None else x0

    def dot_pair(u1, v1, u2, v2):
        d = comm.psum(torch.stack([local_dot(u1, v1), local_dot(u2, v2)]))
        return d[0], d[1]

    def dot_one(u, v):
        return comm.psum(local_dot(u, v))

    bb = dot_one(b, b)
    tol = rhs_norm_scale(torch.sqrt(bb), rtol, atol)

    def solve_from(x, tol2, k):
        r = b - op(x)
        z = M(r)
        p = z
        rz, rr = dot_pair(r, z, r, r)
        while k < maxiter and bool((rr > tol2).any()):
            active = rr > tol2
            ap = op(p)
            pap = dot_one(p, ap)
            alpha = torch.where(active, safe_divide(rz, pap),
                                torch.zeros_like(rz))
            x = x + bcast_cols(alpha, p)
            r = r - bcast_cols(alpha, ap)
            z = M(r)
            rz_new, rr_new = dot_pair(r, z, r, r)
            beta = torch.where(active, safe_divide(rz_new, rz),
                               torch.zeros_like(rz))
            p = z + bcast_cols(beta, p)
            rz = torch.where(active, rz_new, rz)
            rr = torch.where(active, rr_new, rr)
            k += 1
        return x, k

    x, k, resnorm, conv = certified_solve(solve_from, op, b, x, tol, maxiter,
                                          comm)
    return SolveResult(x=x, iters=k, resnorm=resnorm, converged=conv)
