"""RCG: recycling (deflated) conjugate gradients, and PCPG.

Counterpart of ``trilinos_tpu/solvers/rcg.py`` (Belos::RCGSolMgr,
Belos::PCPGSolMgr). For a sequence of SPD systems with the same or a
slowly varying operator, a recycle space U spans the lowest modes; each
solve starts with the exact solution in span(U) and runs CG in the
A-orthogonal complement, so the low eigenvalues that throttle CG never
come back. The space is built from the smallest Ritz vectors of a Lanczos
run (``eigen.lanczos_eigs``) on the first solve; the projector uses the
small factor (UᵀAU)⁻¹, formed again for each system. PCPG is the same
iteration with a user-supplied basis as U.
"""
from __future__ import annotations

import torch

from ..ops.blas import local_dot
from ..parallel.comm import Comm, SerialComm
from .base import (Operator, SolveResult, certified_solve, identity_prec,
                   rhs_norm_scale, safe_divide)


class CgRecycleSpace:
    """(U, A U, (UᵀAU)⁻¹) carried across solves."""

    def __init__(self, u=None, au=None, utau_inv=None):
        self.u = u
        self.au = au
        self.utau_inv = utau_inv

    @property
    def size(self) -> int:
        return 0 if self.u is None else self.u.shape[1]


def _recycle_from(op, comm, u) -> CgRecycleSpace:
    """The space on ``u`` mapped onto ``op``: A U and (UᵀAU)⁻¹ (k applies
    as one block apply)."""
    au = op(u)
    utau = comm.psum(u.T @ au)
    return CgRecycleSpace(u, au, torch.linalg.inv((utau + utau.T) / 2))


def _build_recycle(op, comm, v0, k: int) -> CgRecycleSpace:
    from ..eigen.lanczos import lanczos_eigs

    # Lanczos's default length, min(4k + 20, n − 1), over the global rows
    _, u = lanczos_eigs(op, v0, nev=k, which="SA", comm=comm)
    return _recycle_from(op, comm, u.contiguous())


def rcg(op: Operator, b: torch.Tensor, x0: torch.Tensor | None = None, *,
        recycle_dim: int = 8, rtol: float = 1e-8, atol: float = 0.0,
        maxiter: int = 1000, comm: Comm | None = None,
        prec: Operator | None = None,
        recycle: CgRecycleSpace | None = None
        ) -> tuple[SolveResult, CgRecycleSpace]:
    """Deflated (recycling) CG for SPD sequences, single RHS. Returns
    (result, recycle_space); pass the space into the next related solve.
    ``prec``: an SPD preconditioner (deflated PCG): z = M r drives the
    search directions and the rz recurrence, while convergence is gated on
    the unpreconditioned residual. A given space is mapped onto this
    operator first (A U and (UᵀAU)⁻¹ again: a stale factor breaks
    A-orthogonality)."""
    comm = comm or SerialComm()
    x = torch.zeros_like(b) if x0 is None else x0
    M = prec or identity_prec
    if recycle is None or recycle.u is None:
        recycle = _build_recycle(op, comm, b - op(x), recycle_dim)
    else:
        recycle = _recycle_from(op, comm, recycle.u)
    u, au, utau_inv = recycle.u, recycle.au, recycle.utau_inv

    def deflate(v):
        """v − U (UᵀAU)⁻¹ (AU)ᵀ v: keeps search directions A-orthogonal
        to U."""
        return v - u @ (utau_inv @ comm.psum(au.T @ v))

    tol = rhs_norm_scale(torch.sqrt(comm.psum(local_dot(b, b))), rtol, atol)

    def solve_from(x, tol2, k):
        # the exact solve in span(U), idempotent, so safe on a retry pass
        r = b - op(x)
        x = x + u @ (utau_inv @ comm.psum(u.T @ r))
        r = b - op(x)
        z = M(r)
        d = comm.psum(torch.stack([local_dot(r, r), local_dot(r, z)]))
        rr, rz = d[0], d[1]
        p = deflate(z)
        while k < maxiter and bool(rr > tol2):
            ap = op(p)
            alpha = safe_divide(rz, comm.psum(local_dot(p, ap)))
            x = x + alpha * p
            r = r - alpha * ap
            z = M(r)
            d = comm.psum(torch.stack([local_dot(r, r), local_dot(r, z)]))
            rr, rz_new = d[0], d[1]
            p = deflate(z) + safe_divide(rz_new, rz) * p
            rz = rz_new
            k += 1
        return x, k

    x, k, resnorm, conv = certified_solve(solve_from, op, b, x, tol, maxiter,
                                          comm)
    return (SolveResult(x=x, iters=k, resnorm=resnorm, converged=conv),
            recycle)


def pcpg(op: Operator, b: torch.Tensor, constraint_basis: torch.Tensor,
         x0: torch.Tensor | None = None, *, rtol: float = 1e-8,
         atol: float = 0.0, maxiter: int = 1000, comm: Comm | None = None,
         prec: Operator | None = None) -> SolveResult:
    """Projected (constrained) preconditioned CG: CG in the A-orthogonal
    complement of a user-supplied subspace (e.g. coarse rigid-body modes),
    on RCG's deflation."""
    comm = comm or SerialComm()
    u = constraint_basis
    res, _ = rcg(op, b, x0, recycle_dim=u.shape[1], rtol=rtol, atol=atol,
                 maxiter=maxiter, comm=comm, prec=prec,
                 recycle=CgRecycleSpace(u))
    return res
