"""Block GCRO-DR: recycling block GMRES for several right-hand sides.

Counterpart of ``trilinos_tpu/solvers/block_gcrodr.py``
(Belos::BlockGCRODRSolMgr): all nrhs columns share one block Krylov space
and one recycle space U with C = A U, CᵀC = I. A cycle: the exact solve in
range(U); block Arnoldi on the C-deflated operator with CGS2 against the
filled prefix and CholQR2 normalisation; the block least squares and the
GCRO update X += V Y − U (B Y). After the first cycle the recycle space
comes from the harmonic Ritz vectors of the block Hessenberg, the
generalized eigenproblem H̄ᵀH̄ g = θ H_mᵀ g solved by scipy on the host
from H alone; U = V P is formed on the device (see ``gcrodr``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.blas import local_dot
from ..parallel.comm import Comm, SerialComm
from .base import Operator, SolveResult
from .gcrodr import (RecycleSpace, _orthonormalize_cu, _right_prec_solve,
                     _ritz_columns, _start_space)
from .ortho import cgs2_project_window, cholqr2, masked_lstsq


def _block_cycle(op, m, comm, b, x, u, c, has_recycle):
    """One block GCRO cycle. b, x: (n, nb); u, c: (n, k). Returns (x, the
    per-column residual norms, V (n, (m+1)·nb), H)."""
    n, nb = b.shape
    dt, dev = b.dtype, b.device
    r = b - op(x)
    if has_recycle:
        ctr = comm.psum(c.T @ r)
        x = x + u @ ctr
        r = r - c @ ctr
    v0, r0, _ = cholqr2(comm, r)
    mp1 = (m + 1) * nb
    v = torch.empty((n, mp1), dtype=dt, device=dev)  # read up to filled
    v[:, :nb] = v0
    h = torch.zeros((mp1, m * nb), dtype=dt, device=dev)
    bmat = torch.zeros((c.shape[1] if has_recycle else 0, m * nb), dtype=dt,
                       device=dev)
    for j in range(m):
        cols = slice(j * nb, (j + 1) * nb)
        w = op(v[:, cols].contiguous())
        if has_recycle:
            cw = comm.psum(c.T @ w)
            w = w - c @ cw
            bmat[:, cols] = cw
        w2, hc = cgs2_project_window(comm, v, w, (j + 1) * nb, chunk=nb)
        q, r_small, _ = cholqr2(comm, w2)
        v[:, (j + 1) * nb:(j + 2) * nb] = q
        hc[(j + 1) * nb:(j + 2) * nb] = r_small
        h[:, cols] = hc
    rhs = torch.zeros((mp1, nb), dtype=dt, device=dev)
    rhs[:nb] = r0
    y = masked_lstsq(h, rhs)  # the happy-breakdown guard
    x = x + v[:, :m * nb] @ y
    if has_recycle:
        x = x - u @ (bmat @ y)
    r = b - op(x)
    return x, torch.sqrt(comm.psum(local_dot(r, r))), v, h


def _block_harmonic_coeffs(h_np: np.ndarray, k: int):
    """Coefficients P (m·nb, k) of the k smallest harmonic Ritz vectors of
    the block Hessenberg: generalized eig H̄ᵀH̄ g = θ H_mᵀ g (scipy, host).
    None if fewer than k finite pairs."""
    import scipy.linalg as sla

    mnb = h_np.shape[1]
    try:
        theta, g = sla.eig(h_np.T @ h_np, h_np[:mnb, :].T, right=True)
    except Exception:
        return None
    finite = np.isfinite(theta)
    if finite.sum() < k:
        return None
    # non-finite pairs (a singular pencil) would poison the pairing below
    return _ritz_columns(theta[finite], g[:, finite], k)


def block_gcrodr(op: Operator, b: torch.Tensor,
                 x0: torch.Tensor | None = None, *, num_blocks: int = 20,
                 recycle_dim: int = 8, max_cycles: int = 40,
                 rtol: float = 1e-8, atol: float = 0.0,
                 comm: Comm | None = None, prec: Operator | None = None,
                 recycle: RecycleSpace | None = None
                 ) -> tuple[SolveResult, RecycleSpace]:
    """Solve A X = B (B of shape (n, nrhs)) with block recycling; returns
    (result, recycle_space). ``prec``: a right preconditioner (see
    ``gcrodr``); reuse the space only with the same preconditioner.
    ``iters`` is cycles × num_blocks."""
    comm = comm or SerialComm()
    if b.ndim != 2:
        raise ValueError("block_gcrodr expects a 2-D multivector RHS")
    if prec is not None:
        return _right_prec_solve(
            lambda opc, r0, ta: block_gcrodr(
                opc, r0, num_blocks=num_blocks, recycle_dim=recycle_dim,
                max_cycles=max_cycles, rtol=0.0, atol=ta, comm=comm,
                recycle=recycle),
            op, prec, b, x0, rtol, atol, comm)
    m, k = num_blocks, recycle_dim
    nb = b.shape[1]
    x = torch.zeros_like(b) if x0 is None else x0
    bnorm = torch.sqrt(comm.psum(local_dot(b, b))).cpu().numpy()
    tol = rtol * np.where(bnorm > 0, bnorm, 1.0) + atol
    u, c, has_rec = _start_space(op, comm, recycle, b.dtype)
    rn, cycles = np.full(nb, np.inf), 0
    while cycles < max_cycles and (rn > tol).any():
        x, rn_t, v, h = _block_cycle(op, m, comm, b, x, u, c, has_rec)
        rn = rn_t.cpu().numpy()
        cycles += 1
        if not has_rec:
            p = _block_harmonic_coeffs(h.cpu().numpy(), k)
            if p is not None:
                u, c, has_rec = _orthonormalize_cu(
                    op, comm, v[:, :m * nb] @ torch.from_numpy(p).to(v))
    result = SolveResult(x=x, iters=cycles * m,
                         resnorm=torch.from_numpy(rn).to(b.device),
                         converged=torch.from_numpy(rn <= tol).to(b.device))
    return result, RecycleSpace(u if has_rec else None,
                                c if has_rec else None)
