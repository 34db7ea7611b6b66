"""True block conjugate gradients (one shared Krylov space).

Counterpart of ``trilinos_tpu/solvers/block_cg.py`` (Belos::BlockCGIter
behind BlockCGSolMgr): all s right-hand sides share one block Krylov
space. Per iteration: one block operator apply, two s×s block inner
products (PᵀAP and ZᵀR, one psum each) and two s×s least-squares solves
on the device.

Rank deficiency (converged or linearly dependent columns) is handled by a
minimum-norm least-squares solve of the block coefficients, as in the
reference. ``jnp.linalg.lstsq`` is an SVD solve with cut-off
eps·max(m, n) relative to the largest singular value; CUDA's
``torch.linalg.lstsq`` offers only the ``gels`` routine, which assumes full
rank, so ``_ls_solve`` is that SVD solve written out. All columns iterate
until every column passes; convergence is certified by an explicit
residual. The GEMMs run in full float32 (TF32 off, the package's rule).
"""
from __future__ import annotations

import torch

from ..ops.blas import local_dot, mv_trans_mv
from ..parallel.comm import Comm, SerialComm
from .base import (Operator, SolveResult, certified_solve, identity_prec,
                   rhs_norm_scale)


def _block_dot(comm: Comm, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(s, s) global block inner product UᵀV."""
    return comm.psum(mv_trans_mv(u, v))


def _ls_solve(a: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Minimum-norm least-squares solve of a small system, robust to rank
    loss: singular values below eps·max(m, n)·σ_max (or zero) are dropped,
    as ``jnp.linalg.lstsq`` does with its default rcond."""
    m, n = a.shape
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    rcond = torch.finfo(a.dtype).eps * max(m, n)
    keep = (s > 0) & (s >= rcond * s[0])
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    return vh.mH @ (s_inv[:, None] * (u.mH @ rhs))


def block_cg(op: Operator, b: torch.Tensor, x0: torch.Tensor | None = None,
             *, prec: Operator | None = None, rtol: float = 1e-8,
             atol: float = 0.0, maxiter: int = 1000,
             comm: Comm | None = None) -> SolveResult:
    """Solve A X = B for an (n, s) block of right-hand sides in one shared
    block Krylov space. A and the preconditioner must be SPD."""
    comm = comm or SerialComm()
    M = prec or identity_prec
    was_1d = b.ndim == 1
    if was_1d:
        b = b[:, None]
    x = torch.zeros_like(b) if x0 is None else (
        x0[:, None] if was_1d and x0.ndim == 1 else x0)
    bb = comm.psum(local_dot(b, b))
    tol = rhs_norm_scale(torch.sqrt(bb), rtol, atol)

    def solve_from(x, tol2, k):
        r = b - op(x)
        z = M(r)
        p = z
        s_zr = _block_dot(comm, z, r)
        rr = comm.psum(local_dot(r, r))
        while k < maxiter and bool((rr > tol2).any()):
            ap = op(p)
            alpha = _ls_solve(_block_dot(comm, p, ap), s_zr)  # (s, s)
            x = torch.addmm(x, p, alpha)
            r = torch.addmm(r, ap, alpha, alpha=-1)
            z = M(r)
            s_new = _block_dot(comm, z, r)
            p = torch.addmm(z, p, _ls_solve(s_zr, s_new))
            s_zr = s_new
            rr = comm.psum(local_dot(r, r))
            k += 1
        return x, k

    x, k, resnorm, conv = certified_solve(solve_from, op, b, x, tol, maxiter,
                                          comm)
    if was_1d:
        return SolveResult(x=x[:, 0], iters=k, resnorm=resnorm[0],
                           converged=conv[0])
    return SolveResult(x=x, iters=k, resnorm=resnorm, converged=conv)
