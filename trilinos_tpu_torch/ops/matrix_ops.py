"""Sparse matrix-matrix algebra on host CSR (AMG setup time).

Counterpart of ``trilinos_tpu/ops/matrix_ops.py``. :func:`spgemm` runs the
port's native C++ helper (``trilinos_tpu_torch/native``, built with g++ at
first use; its values are float64, as the JAX package's) and takes the
vectorized numpy path, :func:`spgemm_numpy`, only where no g++ is found.
``spgemm.native_calls`` and ``spgemm.numpy_calls`` count which path served.
"""
from __future__ import annotations

import numpy as np

from ..native import spgemm_native
from .formats import CsrHost


def spgemm(a: CsrHost, b: CsrHost) -> CsrHost:
    """C = A @ B (duplicate products summed)."""
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"shape mismatch {a.shape} @ {b.shape}")
    c = spgemm_native(a, b)
    if c is None:
        spgemm.numpy_calls += 1
        return spgemm_numpy(a, b)
    spgemm.native_calls += 1
    return CsrHost(*c, (a.shape[0], b.shape[1]))


spgemm.native_calls = 0
spgemm.numpy_calls = 0


def spgemm_numpy(a: CsrHost, b: CsrHost) -> CsrHost:
    """C = A @ B by vectorized numpy: the plain version of the native
    helper (same structure, values in the operands' type)."""
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"shape mismatch {a.shape} @ {b.shape}")
    a_rows = a._rows()
    counts = np.diff(b.row_ptr)[a.cols]
    total = int(counts.sum())
    if total == 0:
        return CsrHost.from_coo(np.zeros(0, np.int64), np.zeros(0, np.int64),
                                np.zeros(0, a.vals.dtype),
                                (a.shape[0], b.shape[1]))
    starts = b.row_ptr[a.cols]
    ends = np.cumsum(counts)
    inner = np.arange(total, dtype=np.int64) - np.repeat(ends - counts,
                                                         counts)
    b_idx = np.repeat(starts, counts) + inner
    rows = np.repeat(a_rows, counts)
    cols = b.cols[b_idx].astype(np.int64)
    vals = np.repeat(a.vals, counts) * b.vals[b_idx]
    return CsrHost.from_coo(rows, cols, vals, (a.shape[0], b.shape[1]),
                            sum_duplicates=True)


def spadd(a: CsrHost, b: CsrHost, alpha: float = 1.0,
          beta: float = 1.0) -> CsrHost:
    """C = alpha·A + beta·B."""
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} + {b.shape}")
    rows = np.concatenate([a._rows(), b._rows()])
    cols = np.concatenate([a.cols.astype(np.int64), b.cols.astype(np.int64)])
    vals = np.concatenate([alpha * a.vals, beta * b.vals])
    return CsrHost.from_coo(rows, cols, vals, a.shape, sum_duplicates=True)


def ptap(a: CsrHost, p: CsrHost) -> CsrHost:
    """Galerkin triple product Pᵀ A P."""
    return spgemm(spgemm(p.transpose(), a), p)


def diag_matrix(d: np.ndarray) -> CsrHost:
    n = len(d)
    idx = np.arange(n, dtype=np.int64)
    return CsrHost.from_coo(idx, idx, np.asarray(d), (n, n),
                            sum_duplicates=False)
