"""Matrix filters and condition estimates.

Counterpart of ``trilinos_tpu/ops/filters.py``: Ifpack2's filter family
(Ifpack2_LocalFilter, DiagonalFilter, DropFilter, SparsityFilter,
SingletonFilter and ReorderFilter; the EpetraExt transforms) as eager host
CSR → host CSR copies made at preconditioner set-up, and Ifpack's
condition estimate (Ifpack_Condest.h) of a preconditioner or operator
apply on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device, torch_dtype
from .formats import CsrHost


def local_filter(a: CsrHost, lo: int, hi: int) -> CsrHost:
    """Rows lo..hi restricted to columns lo..hi, renumbered from 0
    (Ifpack2::LocalFilter, the basis of process-local
    preconditioners)."""
    rows, cols = a._rows(), a.cols.astype(np.int64)
    keep = (rows >= lo) & (rows < hi) & (cols >= lo) & (cols < hi)
    return CsrHost.from_coo(rows[keep] - lo, cols[keep] - lo, a.vals[keep],
                            (hi - lo, hi - lo), sum_duplicates=False)


def diagonal_filter(a: CsrHost, absolute_threshold: float = 0.0,
                    relative_threshold: float = 1.0) -> CsrHost:
    """The diagonal perturbed, d ← relative·d + sign(d)·absolute
    (Ifpack2::DiagonalFilter; stabilizes incomplete factorizations)."""
    rows = a._rows()
    vals = a.vals.copy()
    on_diag = rows == a.cols
    d = vals[on_diag]
    vals[on_diag] = (relative_threshold * d
                     + np.where(d >= 0, 1.0, -1.0) * absolute_threshold)
    return CsrHost.from_coo(rows, a.cols, vals, a.shape,
                            sum_duplicates=False)


def drop_filter(a: CsrHost, drop_tol: float) -> CsrHost:
    """Off-diagonal entries with |a_ij| < drop_tol dropped
    (Ifpack2::DropFilter)."""
    rows = a._rows()
    keep = (rows == a.cols) | (np.abs(a.vals) >= drop_tol)
    return CsrHost.from_coo(rows[keep], a.cols[keep], a.vals[keep], a.shape,
                            sum_duplicates=False)


def sparsity_filter(a: CsrHost, max_entries_per_row: int,
                    max_bandwidth: int | None = None) -> CsrHost:
    """Only the max_entries_per_row largest off-diagonals of each row kept,
    optionally within a bandwidth (Ifpack2::SparsityFilter)."""
    out_r, out_c, out_v = [], [], []
    for i in range(a.shape[0]):
        c, v = a.row(i)
        if max_bandwidth is not None:
            sel = np.abs(c - i) <= max_bandwidth
            c, v = c[sel], v[sel]
        diag = c == i
        offc, offv = c[~diag], v[~diag]
        if len(offv) > max_entries_per_row:
            keep = np.argsort(-np.abs(offv))[:max_entries_per_row]
            offc, offv = offc[keep], offv[keep]
        out_r.append(np.full(len(offc) + diag.sum(), i))
        out_c.append(np.concatenate([offc, c[diag]]))
        out_v.append(np.concatenate([offv, v[diag]]))
    return CsrHost.from_coo(np.concatenate(out_r), np.concatenate(out_c),
                            np.concatenate(out_v), a.shape,
                            sum_duplicates=False)


def singleton_filter(a: CsrHost) -> tuple[CsrHost, np.ndarray]:
    """Rows with a single entry (Dirichlet rows) removed: the reduced
    matrix and the kept rows (Ifpack2::SingletonFilter)."""
    keep_rows = np.flatnonzero(a.row_lengths() > 1)
    renum = -np.ones(a.shape[0], dtype=np.int64)
    renum[keep_rows] = np.arange(len(keep_rows))
    rows, cols = a._rows(), a.cols.astype(np.int64)
    keep = (renum[rows] >= 0) & (renum[cols] >= 0)
    m = len(keep_rows)
    return (CsrHost.from_coo(renum[rows[keep]], renum[cols[keep]],
                             a.vals[keep], (m, m), sum_duplicates=False),
            keep_rows)


def reorder_filter(a: CsrHost, perm: np.ndarray) -> CsrHost:
    """The symmetric permutation A[perm, perm] (Ifpack2::ReorderFilter)."""
    from ..parallel.partition import permute_csr

    return permute_csr(a, perm)


def condest(prec, n_pad: int, method: str = "cheap", iters: int = 10,
            seed: int = 0, dtype=torch.float64, device=None) -> float:
    """Condition-number proxy of an apply ``prec`` on (n_pad,) vectors of
    ``dtype`` on ``device`` (``None``: the CUDA card) (Ifpack_Condest.h):
    "cheap" = ‖M⁻¹ 1‖_∞ (the reference's default); "power" = a power-method
    estimate of ‖M⁻¹‖₂, which reads one host float a step, as the
    reference does; "lanczos" = λmax/λmin of the extreme Ritz values of one
    Arnoldi factorization (the AztecOO AZ_*_condnum companion, valid for
    SPD applies). The random start vectors are seeded numpy normals, as in
    the reference."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype)

    def normal():
        v = np.random.default_rng(seed).standard_normal(n_pad)
        return torch.from_numpy(v).to(dev, dt)

    if method == "lanczos":
        from ..eigen import arnoldi

        m = min(max(4 * iters, 40), n_pad - 1)
        _, h = arnoldi(prec, normal(), m)
        theta = torch.linalg.eigvalsh((h[:m, :] + h[:m, :].T) / 2)
        return float(theta[-1] / torch.clamp(theta[0], min=1e-300))
    if method == "cheap":
        return float(prec(torch.ones(n_pad, dtype=dt, device=dev)).abs()
                     .max())
    if method == "power":
        v = normal()
        v = v / torch.linalg.vector_norm(v)
        lam = 1.0
        for _ in range(iters):
            w = prec(v)
            lam = float(torch.linalg.vector_norm(w))
            v = w / max(lam, 1e-300)
        return lam
    raise ValueError(f"unknown condest method {method!r}")
