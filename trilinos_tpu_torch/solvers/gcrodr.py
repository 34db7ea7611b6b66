"""GCRO-DR: GMRES with recycling (deflated restarts, recycling across
solves).

Counterpart of ``trilinos_tpu/solvers/gcrodr.py`` (Belos::GCRODRSolMgr,
Parks/de Sturler): a recycle space U with C = A U, CᵀC = I; each cycle
solves exactly in range(U), runs Arnoldi on the C-deflated operator in
the complement, and the first cycle builds U from harmonic Ritz vectors;
U survives restarts and later related solves.

Two changes of form, not of math:

* the reference pulls the whole Arnoldi basis to the host to form
  U = V P (16.7 M × 31 × 4 B = 2.08 GB at 256³). Here the harmonic-Ritz
  coefficients P (m × k) are computed on the host from H alone
  (``_harmonic_ritz_coeffs``: a nonsymmetric eig, as in the reference)
  and U = V[:, :m] P is formed on the device;
* each Arnoldi step projects against the filled prefix of the basis
  (``cgs2_project_window``) instead of the zero-padded whole; the basis is
  stored one vector a row, so every vector the operator sees is
  contiguous.

One host read of the true residual a cycle.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.blas import local_dot
from ..parallel.comm import Comm, SerialComm, norm2
from .base import Operator, SolveResult, safe_divide
from .ortho import cgs2_project_window, cholqr2, masked_lstsq


class RecycleSpace:
    """Carrier for (U, C) across solves (A U = C, CᵀC = I)."""

    def __init__(self, u=None, c=None):
        self.u = u
        self.c = c

    @property
    def size(self) -> int:
        return 0 if self.u is None else self.u.shape[1]


def _right_prec_solve(inner, op, prec, b, x0, rtol, atol, comm):
    """Right preconditioning for gcrodr/block_gcrodr: solve (A∘M) y = r0
    with x = x0 + M y. The composed system's residuals are the true
    residuals of A x = b, so rtol·‖b‖ (per column) becomes an absolute
    tolerance of the inner solve. ``inner(op_composed, r0, tol_abs) ->
    (res, rec)``."""
    x_base = torch.zeros_like(b) if x0 is None else x0
    r0 = b if x0 is None else b - op(x_base)
    bnorm = torch.sqrt(comm.psum(local_dot(b, b))).cpu().numpy()
    tol_abs = rtol * np.where(bnorm > 0, bnorm, 1.0) + atol
    res, rec = inner(lambda v: op(prec(v)), r0, tol_abs)
    return (SolveResult(x=x_base + prec(res.x), iters=res.iters,
                        resnorm=res.resnorm, converged=res.converged), rec)


def _cycle(op, m, comm, b, x, u, c, has_recycle):
    """One GCRO cycle: the correction in range(U), m deflated Arnoldi steps
    (all m: a captured residual leaves trailing columns that the masked
    least squares drops) and the GCRO update. Returns (x, ‖r‖, V as (m+1,
    n) rows, H)."""
    n, dt, dev = b.shape[0], b.dtype, b.device
    r = b - op(x)
    if has_recycle:
        ctr = comm.psum(c.T @ r)
        x = x + u @ ctr
        r = r - c @ ctr
    beta = norm2(comm, r)
    vt = torch.zeros((m + 1, n), dtype=dt, device=dev)
    vt[0] = safe_divide(r, beta)
    h = torch.zeros((m + 1, m), dtype=dt, device=dev)
    bm = torch.zeros((c.shape[1] if has_recycle else 0, m), dtype=dt,
                     device=dev)  # B = Cᵀ A V_m
    for j in range(m):
        w = op(vt[j])
        if has_recycle:
            cw = comm.psum(c.T @ w)
            w = w - c @ cw
            bm[:, j] = cw
        w2, hc = cgs2_project_window(comm, vt.T, w[:, None], j + 1, chunk=1)
        w2 = w2[:, 0]
        hn = norm2(comm, w2)
        h[:, j] = hc[:, 0]
        h[j + 1, j] = hn
        vt[j + 1] = safe_divide(w2, hn)
    e1 = torch.zeros(m + 1, dtype=dt, device=dev)
    e1[0] = beta
    y = masked_lstsq(h, e1)
    # the GCRO update: A U = C, so x += V y − U (Cᵀ A V) y keeps the new
    # residual orthogonal to C
    x = x + vt[:m].T @ y
    if has_recycle:
        x = x - u @ (bm @ y)
    return x, norm2(comm, b - op(x)), vt, h


def _harmonic_ritz_coeffs(h_np: np.ndarray, k: int):
    """Coefficients P (m, k) of the k smallest harmonic Ritz vectors of the
    Arnoldi Hessenberg H ((m+1, m), host), so that U = V[:, :m] P (the
    reference's getHarmonicVecs; a complex pair gives its real and
    imaginary parts). None if H's square part is singular."""
    m = h_np.shape[1]
    hm = h_np[:m, :]
    hlast = h_np[m, m - 1]
    try:
        f = np.linalg.solve(hm.T, np.eye(m)[:, -1])
    except np.linalg.LinAlgError:
        return None
    theta, g = np.linalg.eig(hm + (hlast ** 2) * np.outer(f, np.eye(m)[-1]))
    return _ritz_columns(theta, g, k)


def _ritz_columns(theta: np.ndarray, g: np.ndarray, k: int):
    """The k columns of the eigenvectors g whose eigenvalues theta are
    smallest in modulus; a complex pair gives its real and imaginary parts
    and its conjugate is skipped."""
    cols, used = [], set()
    for idx in np.argsort(np.abs(theta)):
        if len(cols) >= k:
            break
        if idx in used:
            continue
        vec = g[:, idx]
        if np.abs(theta[idx].imag) > 1e-12:
            cols.append(np.real(vec))
            cols.append(np.imag(vec))
            used.add(int(np.argmin(np.abs(theta - np.conj(theta[idx])))))
        else:
            cols.append(np.real(vec))
        used.add(int(idx))
    return np.stack(cols[:k], axis=1)


def _orthonormalize_cu(op, comm, u):
    """C = A U orthonormalised by CholQR2 (C = Q R), U ← U R⁻¹. The third
    result is False when the panel is numerically rank-deficient (CholQR2's
    rank flags): callers then drop the recycle space."""
    c_q, r_c, ok = cholqr2(comm, op(u))
    # row-major, as the operators' multivector kernels take it
    u_new = torch.linalg.solve_triangular(r_c, u, upper=True,
                                          left=False).contiguous()
    return u_new, c_q, bool(ok.all())


def _start_space(op, comm, recycle, dtype):
    """(U, C, has_recycle) of a given space mapped onto this operator: C
    must equal A U exactly, and a sequence of systems changes A (k applies
    and one CholQR2)."""
    if recycle is None or recycle.u is None:
        return None, None, False
    u, c, ok = _orthonormalize_cu(op, comm, recycle.u.to(dtype))
    return (u, c, True) if ok else (None, None, False)


def gcrodr(op: Operator, b: torch.Tensor, x0: torch.Tensor | None = None, *,
           num_blocks: int = 30, recycle_dim: int = 8, max_cycles: int = 40,
           rtol: float = 1e-8, atol: float = 0.0, comm: Comm | None = None,
           prec: Operator | None = None,
           recycle: RecycleSpace | None = None
           ) -> tuple[SolveResult, RecycleSpace]:
    """Solve with recycling; returns (result, recycle_space), the space to
    pass into the next related solve. ``prec``: a right preconditioner,
    solved as (A∘M) y = r0 with x = x0 + M y; the recycle space then lives
    in the composed operator's coordinates, so reuse it only with the same
    preconditioner. ``iters`` is cycles × num_blocks."""
    comm = comm or SerialComm()
    if prec is not None:
        return _right_prec_solve(
            lambda opc, r0, ta: gcrodr(
                opc, r0, num_blocks=num_blocks, recycle_dim=recycle_dim,
                max_cycles=max_cycles, rtol=0.0, atol=ta, comm=comm,
                recycle=recycle),
            op, prec, b, x0, rtol, atol, comm)
    m, k = num_blocks, recycle_dim
    x = torch.zeros_like(b) if x0 is None else x0
    bnorm = float(norm2(comm, b))
    tol = rtol * (bnorm if bnorm > 0 else 1.0) + atol
    u, c, has_rec = _start_space(op, comm, recycle, b.dtype)
    rn, cycles = math.inf, 0
    while cycles < max_cycles and rn > tol:
        x, rn_t, vt, h = _cycle(op, m, comm, b, x, u, c, has_rec)
        rn = float(rn_t)
        cycles += 1
        if not has_rec:
            # the first cycle's Arnoldi data builds the recycle space
            p = _harmonic_ritz_coeffs(h.cpu().numpy(), k)
            if p is not None:
                u, c, has_rec = _orthonormalize_cu(
                    op, comm, vt[:m].T @ torch.from_numpy(p).to(vt))
    result = SolveResult(x=x, iters=cycles * m,
                         resnorm=torch.tensor(rn, dtype=b.dtype,
                                              device=b.device),
                         converged=torch.tensor(rn <= tol, device=b.device))
    return result, RecycleSpace(u if has_rec else None,
                                c if has_rec else None)
