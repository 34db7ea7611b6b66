"""Block GMRES: one Krylov space shared by all right-hand sides.

Counterpart of ``trilinos_tpu/solvers/block_gmres.py`` (Belos'
BlockGmresIter + BlockGmresSolMgr): right-preconditioned block Arnoldi with
CGS2 or DGKS projection and CholQR2 block normalisation, and a progressive
block QR of the Hessenberg matrix (each step annihilates the new
subdiagonal block with one 2nb×2nb Householder QR and reads every column's
implicit residual from the next block of the transformed right-hand side).
Restarts are gated on the true residual.

JAX's ``lax.while_loop`` becomes a Python loop: one host read of
``any(est > tol)`` per block step, as CG reads its ``rr`` once per
iteration, and one of the true residual per restart. The basis is
(n, (m+1)·nb), 27.9 GB at 256³ with nb = 16 in f32, so

* each step projects against the filled prefix only (the ``*_window``
  passes; the JAX package's zero-padded columns add nothing to c), and the
  GEMMs read that strided prefix in place: the basis is never transposed
  or copied whole;
* the working block v_j is copied out contiguous (the kernels take
  contiguous x), one (n, nb) block;
* unfilled columns are never read, so the basis is allocated once per
  solve and not zeroed.

QR signs from ``torch.linalg.qr`` may differ from XLA's; the transformed
Hessenberg then differs by signs, the residual estimates and y do not.
"""
from __future__ import annotations

import torch

from ..ops.blas import local_dot, mv_times_mat_add_mv
from ..parallel.comm import Comm, SerialComm
from .base import Operator, SolveResult, identity_prec, rhs_norm_scale
from .ortho import (cgs2_project_window, cholqr2, dgks_project_window,
                    resolve_method)


def block_gmres(op: Operator, b: torch.Tensor, x0: torch.Tensor | None = None,
                *, prec: Operator | None = None, num_blocks: int = 30,
                max_restarts: int = 20, rtol: float = 1e-8,
                atol: float = 0.0, comm: Comm | None = None,
                ortho: str = "CGS2", basis_dtype=None) -> SolveResult:
    """Right-preconditioned block GMRES(m) for B of shape (n, nrhs).

    ``basis_dtype`` (e.g. ``torch.bfloat16``) stores the Krylov basis
    narrower than b; the working block, the CholQR panels and the
    progressive QR stay in b's dtype, and each basis block is widened to it
    before its GEMM. ``iters`` counts block steps over all cycles."""
    comm = comm or SerialComm()
    M = prec or identity_prec
    if b.ndim != 2:
        raise ValueError("block_gmres expects a 2-D multivector RHS")
    n, nb = b.shape
    m = num_blocks
    ortho_m = resolve_method(ortho)
    if ortho_m in ("MGS1", "IMGS"):
        # the block iteration is written against block (CGS-style)
        # projections; raising beats a silent substitution
        raise ValueError(
            "block_gmres supports CGS2/ICGS/DGKS orthogonalization; "
            "use gmres() for the MGS/IMGS path")
    project = (dgks_project_window if ortho_m == "DGKS"
               else cgs2_project_window)
    x = torch.zeros_like(b) if x0 is None else x0
    dtype = b.dtype
    bdt = basis_dtype or dtype
    mp1 = (m + 1) * nb
    bnorm = torch.sqrt(comm.psum(local_dot(b, b)))
    tol = rhs_norm_scale(bnorm, rtol, atol)
    v = torch.empty((n, mp1), dtype=bdt, device=b.device)

    def cycle(x):
        r = b - op(x)
        v0, r0_small, _ = cholqr2(comm, r)
        v[:, :nb] = v0
        # progressive QR state: qt = accumulated Qᵀ, rfac = R, g = Qᵀ e1 R0
        qt = torch.eye(mp1, dtype=dtype, device=b.device)
        rfac = torch.zeros((m * nb, m * nb), dtype=dtype, device=b.device)
        g = torch.zeros((mp1, nb), dtype=dtype, device=b.device)
        g[:nb] = r0_small
        est = torch.sqrt((r0_small * r0_small).sum(0))
        j = 0
        while j < m and bool((est > tol).any()):
            lo, mid, hi = j * nb, (j + 1) * nb, (j + 2) * nb
            w = op(M(v[:, lo:mid].to(dtype).contiguous()))
            w2, hcol = project(comm, v, w, mid, chunk=nb)
            q, r_small, _ = cholqr2(comm, w2)
            v[:, mid:hi] = q
            hcol[mid:hi] = r_small
            # apply the accumulated transforms, then annihilate the new
            # subdiagonal block with one small complete QR
            cp = qt @ hcol
            qs, rs = torch.linalg.qr(cp[lo:hi], mode="complete")
            qt[lo:hi] = qs.T @ qt[lo:hi]
            g[lo:hi] = qs.T @ g[lo:hi]
            cp[lo:mid] = rs[:nb]
            cp[mid:hi] = 0
            rfac[:, lo:mid] = cp[:m * nb]
            # implicit residual per column: the next g block's column norms
            est = torch.sqrt((g[mid:hi] * g[mid:hi]).sum(0))
            j += 1
        if j:
            y = torch.linalg.solve_triangular(rfac[:j * nb, :j * nb],
                                              g[:j * nb], upper=True)
            x = x + M(mv_times_mat_add_mv(1.0, v[:, :j * nb], y, 0.0, None))
        return x, j

    def res_norms(x):
        r = b - op(x)
        return torch.sqrt(comm.psum(local_dot(r, r)))

    rn = res_norms(x)
    cycles = steps = 0
    while cycles < max_restarts + 1 and bool((rn > tol).any()):
        x, j = cycle(x)
        rn = res_norms(x)
        cycles += 1
        steps += j
    return SolveResult(x=x, iters=steps, resnorm=rn, converged=rn <= tol)
