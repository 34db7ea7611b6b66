"""Local sparse-matrix storage: host CSR; device ELL, DIA, BSR and block
DIA.

Counterpart of ``trilinos_tpu/ops/formats.py``. ``CsrHost`` is the numpy
assembly substrate (a copy: the port imports nothing of the JAX package).
``EllMatrix`` holds ``cols``/``vals`` of shape ``(n_rows_pad, k)``,
``DiaMatrix`` its diagonals as one ``(n_diags, n_rows_pad)`` tensor,
``BsrMatrix`` block columns ``(n_brows_pad, kb)`` and dense blocks
``(n_brows_pad, kb, b, b)``, and ``BdiaMatrix`` its block planes as one
``(nd, b, b, nbr_pad)`` tensor; the JAX package's ``(…, R, 128)`` lane
packing is TPU layout and has no counterpart here. ``choose_format``
picks one of them once, at pack time.

Padding convention (as in the reference): rows added to reach the padded
row count are identity rows and the matching vector entries are zero, so
SpMV maps zero padding to zero padding.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import numpy_dtype, resolve_device, torch_dtype

ROW_ALIGN = 8  # every padded row count is a multiple of this


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class CsrHost:
    """Numpy CSR with duplicate-summing construction from COO."""

    def __init__(self, row_ptr: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                 shape: tuple[int, int]):
        self.row_ptr = np.asarray(row_ptr, dtype=np.int64)
        self.cols = np.asarray(cols, dtype=np.int32)
        self.vals = np.asarray(vals)
        self.shape = shape
        if self.row_ptr.shape != (shape[0] + 1,):
            raise ValueError(f"row_ptr length {self.row_ptr.shape[0]} != "
                             f"{shape[0] + 1}")

    @classmethod
    def from_coo(cls, rows, cols, vals, shape, sum_duplicates=True) -> "CsrHost":
        # one stable sort on the fused (row, col) key; duplicates are then
        # adjacent and merge with one add.reduceat
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals)
        key = rows * np.int64(shape[1]) + cols
        if not (len(key) and np.all(key[1:] >= key[:-1])):
            order = np.argsort(key, kind="stable")
            key, vals = key[order], vals[order]
        if sum_duplicates and len(key):
            newseg = np.empty(len(key), dtype=bool)
            newseg[0] = True
            np.not_equal(key[1:], key[:-1], out=newseg[1:])
            starts = np.flatnonzero(newseg)
            key = key[starts]
            vals = np.add.reduceat(vals, starts)
        rows = key // shape[1]
        cols = key % shape[1]
        counts = np.bincount(rows, minlength=shape[0])
        row_ptr = np.zeros(shape[0] + 1, dtype=np.int64)
        np.cumsum(counts, out=row_ptr[1:])
        return cls(row_ptr, cols.astype(np.int32), vals, shape)

    @classmethod
    def from_dense(cls, a: np.ndarray, tol: float = 0.0) -> "CsrHost":
        a = np.asarray(a)
        rows, cols = np.nonzero(np.abs(a) > tol)
        return cls.from_coo(rows, cols, a[rows, cols], a.shape)

    @property
    def nnz(self) -> int:
        return len(self.cols)

    def row_lengths(self) -> np.ndarray:
        return np.diff(self.row_ptr)

    def max_row_length(self) -> int:
        return int(self.row_lengths().max(initial=0))

    def row(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        s, e = self.row_ptr[i], self.row_ptr[i + 1]
        return self.cols[s:e], self.vals[s:e]

    def _rows(self) -> np.ndarray:
        return np.repeat(np.arange(self.shape[0], dtype=np.int64),
                         self.row_lengths())

    def diagonal(self) -> np.ndarray:
        d = np.zeros(min(self.shape), dtype=self.vals.dtype)
        rows = self._rows()
        hit = (self.cols == rows) & (rows < min(self.shape))
        # first matching entry per row wins
        idx = np.flatnonzero(hit)[::-1]
        d[rows[idx]] = self.vals[idx]
        return d

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.vals.dtype)
        np.add.at(out, (self._rows(), self.cols), self.vals)
        return out

    def matvec_host(self, x: np.ndarray) -> np.ndarray:
        """Host-side y = A x (set-up and verification paths)."""
        y = np.zeros(self.shape[0],
                     dtype=np.result_type(self.vals, np.asarray(x)))
        np.add.at(y, self._rows(), self.vals * np.asarray(x)[self.cols])
        return y

    def submatrix(self, row_ids: np.ndarray,
                  col_ids: np.ndarray) -> "CsrHost":
        """A[row_ids][:, col_ids] (host set-up, e.g. the condensation of
        boundary dofs)."""
        row_ids = np.asarray(row_ids)
        col_ids = np.asarray(col_ids)
        col_pos = np.full(self.shape[1], -1, dtype=np.int64)
        col_pos[col_ids] = np.arange(len(col_ids))
        rows_full = self._rows()
        row_pos = np.full(self.shape[0], -1, dtype=np.int64)
        row_pos[row_ids] = np.arange(len(row_ids))
        keep = (row_pos[rows_full] >= 0) & (col_pos[self.cols] >= 0)
        return CsrHost.from_coo(row_pos[rows_full[keep]],
                                col_pos[self.cols[keep]], self.vals[keep],
                                (len(row_ids), len(col_ids)))

    def transpose(self) -> "CsrHost":
        m, n = self.shape
        return CsrHost.from_coo(self.cols.astype(np.int64), self._rows(),
                                self.vals, (n, m))


@dataclasses.dataclass(frozen=True, eq=False)
class EllMatrix:
    """Padded ELLPACK: ``cols``/``vals`` of shape ``(n_rows_pad, k)``; short
    rows are padded with (col 0, val 0) entries. ``n_rows``/``n_cols`` are
    the logical sizes."""

    cols: torch.Tensor  # (n_rows_pad, k) int64
    vals: torch.Tensor  # (n_rows_pad, k)
    n_rows: int
    n_cols: int
    nnz: int

    def __post_init__(self):
        if self.cols.ndim != 2 or self.cols.shape != self.vals.shape:
            raise ValueError(f"ELL cols {tuple(self.cols.shape)} and vals "
                             f"{tuple(self.vals.shape)} differ")

    @property
    def n_rows_pad(self) -> int:
        return self.cols.shape[0]

    @property
    def k(self) -> int:
        return self.cols.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    def to_dense(self) -> np.ndarray:
        """Debug helper: the logical (unpadded) dense matrix, float64."""
        out = np.zeros((self.n_rows, self.n_cols))
        cols = self.cols[:self.n_rows].cpu().numpy()
        vals = self.vals[:self.n_rows].double().cpu().numpy()
        rows = np.repeat(np.arange(self.n_rows), self.k)
        np.add.at(out, (rows, cols.reshape(-1)), vals.reshape(-1))
        return out


@dataclasses.dataclass(frozen=True, eq=False)
class DiaMatrix:
    """Diagonal-offset storage: ``y[i] = Σ_d data[d, i] · x[i + offsets[d]]``.

    ``data`` is ``(n_diags, n_rows_pad)``. Positions whose column falls
    outside the matrix hold zeros, so a cyclic shift of x is exact and a
    kernel may equally skip them.
    """

    data: torch.Tensor
    offsets: tuple[int, ...]
    n_rows: int
    n_cols: int
    nnz: int

    def __post_init__(self):
        if self.data.ndim != 2 or self.data.shape[0] != len(self.offsets):
            raise ValueError(
                f"DIA data shape {tuple(self.data.shape)} does not match "
                f"{len(self.offsets)} offsets")

    @property
    def n_rows_pad(self) -> int:
        return self.data.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    def to_dense(self) -> np.ndarray:
        """Debug helper: the logical (unpadded) dense matrix, float64."""
        out = np.zeros((self.n_rows, self.n_cols))
        data = self.data.double().cpu().numpy()
        rows = np.arange(self.n_rows)
        for d, off in enumerate(self.offsets):
            j = rows + off
            ok = (j >= 0) & (j < self.n_cols)
            out[rows[ok], j[ok]] += data[d, rows[ok]]
        return out


def dia_from_host(data: np.ndarray, offsets, n_rows: int, n_cols: int,
                  nnz: int, dtype, device=None) -> DiaMatrix:
    """Move assembled ``(n_diags, n_rows_pad)`` host data to ``device``."""
    t = torch.from_numpy(np.ascontiguousarray(data))
    t = t.to(device=resolve_device(device), dtype=torch_dtype(dtype))
    return DiaMatrix(data=t, offsets=tuple(int(o) for o in offsets),
                     n_rows=n_rows, n_cols=n_cols, nnz=nnz)


def csr_to_dia(a: CsrHost, dtype=None, n_rows_pad: int | None = None,
               max_diags: int | None = None, device=None) -> DiaMatrix:
    """Pack host CSR into diagonal-offset storage on ``device``."""
    m, n = a.shape
    if n_rows_pad is None:
        n_rows_pad = round_up(m, ROW_ALIGN)
    dtype = a.vals.dtype if dtype is None else dtype
    rows_rep = a._rows()
    offs = a.cols.astype(np.int64) - rows_rep
    uniq = np.unique(offs)
    if max_diags is not None and len(uniq) > max_diags:
        raise ValueError(f"{len(uniq)} diagonals exceeds limit {max_diags}")
    data = np.zeros((len(uniq), n_rows_pad), dtype=numpy_dtype(dtype))
    d_idx = np.searchsorted(uniq, offs)
    data[d_idx, rows_rep] = a.vals
    offsets = tuple(int(o) for o in uniq)
    if m == n and 0 in offsets:
        # identity padding rows (keeps the Jacobi diagonal invertible)
        data[offsets.index(0), m:n_rows_pad] = 1.0
    return dia_from_host(data, offsets, m, n, a.nnz, dtype, device)


@dataclasses.dataclass(frozen=True, eq=False)
class BdiaMatrix:
    """Block-diagonal (block-stencil) storage for operators with ``b`` dofs
    per node whose block pattern has constant block-column offsets (Q1
    elasticity: 9 or 27 node neighbours). With residue planes
    ``xp[j, q] = x[q·b + j]`` the apply is

        yp[i, q] = Σ_d Σ_j data[d, i, j, q] · xp[j, q + offsets[d]].

    ``data`` is ``(nd, b, b, nbr_pad)``; ``offsets`` are block offsets
    (block column − block row). Out-of-range plane positions hold zeros, so
    cyclic shifts are exact; padding block rows are identity blocks.
    """

    data: torch.Tensor
    offsets: tuple[int, ...]
    block_size: int
    n_rows: int
    n_cols: int
    nnz: int

    def __post_init__(self):
        b = self.block_size
        if self.data.ndim != 4 or self.data.shape[:3] != (
                len(self.offsets), b, b):
            raise ValueError(
                f"BDIA data shape {tuple(self.data.shape)} does not match "
                f"{len(self.offsets)} offsets of {b}x{b} blocks")

    @property
    def nbr_pad(self) -> int:
        """Padded block-row count."""
        return self.data.shape[3]

    @property
    def n_rows_pad(self) -> int:
        return self.nbr_pad * self.block_size

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    def to_dense(self) -> np.ndarray:
        """Debug helper: the logical (unpadded) dense matrix, float64."""
        b = self.block_size
        out = np.zeros((self.n_rows, self.n_cols))
        data = self.data.double().cpu().numpy()
        q = np.arange(self.n_rows // b)
        for d, off in enumerate(self.offsets):
            for i in range(b):
                for j in range(b):
                    r, c = q * b + i, (q + off) * b + j
                    ok = (r < self.n_rows) & (c >= 0) & (c < self.n_cols)
                    out[r[ok], c[ok]] += data[d, i, j, q[ok]]
        return out


def bdia_from_host(data: np.ndarray, offsets, block_size: int, n_rows: int,
                   n_cols: int, nnz: int, dtype, device=None) -> BdiaMatrix:
    """Move assembled ``(nd, b, b, nbr_pad)`` host data to ``device``."""
    t = torch.from_numpy(np.ascontiguousarray(data))
    t = t.to(device=resolve_device(device), dtype=torch_dtype(dtype))
    return BdiaMatrix(data=t, offsets=tuple(int(o) for o in offsets),
                      block_size=int(block_size), n_rows=n_rows,
                      n_cols=n_cols, nnz=nnz)


def pad_csr_square(a: CsrHost, multiple: int) -> CsrHost:
    """Extend a square host CSR with identity rows/cols so that both dims
    are a multiple of ``multiple``."""
    m, n = a.shape
    if m != n:
        raise ValueError("pad_csr_square requires a square matrix")
    mp = round_up(m, multiple)
    if mp == m:
        return a
    extra = np.arange(m, mp)
    rows = np.concatenate([a._rows(), extra])
    cols = np.concatenate([a.cols.astype(np.int64), extra])
    vals = np.concatenate([a.vals, np.ones(mp - m, dtype=a.vals.dtype)])
    return CsrHost.from_coo(rows, cols, vals, (mp, mp), sum_duplicates=False)


def csr_to_bdia(a: CsrHost, block_size: int, dtype=None,
                nbr_pad: int | None = None, max_diags: int | None = None,
                device=None) -> BdiaMatrix:
    """Pack host CSR into block-diagonal storage on ``device``.

    Scalar entry (r, c) lands in plane (d, r % b, c % b) at block row
    r // b, where d indexes the block offset c//b − r//b. A square matrix
    whose dimension is not a multiple of ``block_size`` is first extended
    with identity rows/cols; a square matrix without a zero block offset
    gets an (identity-padded) zero-offset plane.
    """
    b = block_size
    m, n = a.shape
    if m == n and m % b != 0:
        a = pad_csr_square(a, b)
        m, n = a.shape
    if m % b != 0 or n % b != 0:
        raise ValueError(f"BDIA needs dims divisible by b={b}, got {a.shape}")
    mb = m // b
    if nbr_pad is None:
        nbr_pad = round_up(mb, ROW_ALIGN)
    dtype = a.vals.dtype if dtype is None else dtype
    rows_rep = a._rows()
    brow = rows_rep // b
    offs = a.cols.astype(np.int64) // b - brow
    uniq = np.unique(offs)
    if max_diags is not None and len(uniq) > max_diags:
        raise ValueError(f"{len(uniq)} block offsets exceeds limit {max_diags}")
    if m == n and 0 not in uniq:
        uniq = np.sort(np.append(uniq, 0))
    data = np.zeros((len(uniq), b, b, nbr_pad), dtype=numpy_dtype(dtype))
    d_idx = np.searchsorted(uniq, offs)
    data[d_idx, rows_rep % b, a.cols % b, brow] = a.vals
    offsets = tuple(int(o) for o in uniq)
    if m == n:
        # identity blocks on the padding block rows
        d0 = offsets.index(0)
        for i in range(b):
            data[d0, i, i, mb:nbr_pad] = 1.0
    return bdia_from_host(data, offsets, b, m, n, a.nnz, dtype, device)


@dataclasses.dataclass(frozen=True, eq=False)
class BsrMatrix:
    """Block-ELL with constant block size b: ``bcols`` (n_brows_pad, kb)
    indexes block columns, ``bvals`` (n_brows_pad, kb, b, b) holds the dense
    blocks. The apply gathers x panels and runs one batched matmul per
    block row."""

    bcols: torch.Tensor  # (n_brows_pad, kb) int64
    bvals: torch.Tensor  # (n_brows_pad, kb, b, b)
    block_size: int
    n_rows: int  # scalar rows
    n_cols: int
    nnz: int  # scalar nonzeros

    def __post_init__(self):
        b = self.block_size
        if self.bvals.ndim != 4 or self.bvals.shape != (
                *self.bcols.shape, b, b):
            raise ValueError(f"BSR bvals {tuple(self.bvals.shape)} do not "
                             f"match bcols {tuple(self.bcols.shape)} of "
                             f"{b}x{b} blocks")

    @property
    def n_brows_pad(self) -> int:
        return self.bcols.shape[0]

    @property
    def n_rows_pad(self) -> int:
        return self.n_brows_pad * self.block_size

    @property
    def kb(self) -> int:
        return self.bcols.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.bvals.dtype

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    def to_dense(self) -> np.ndarray:
        """Debug helper: the logical (unpadded) dense matrix, float64."""
        b = self.block_size
        nb = -(-self.n_cols // b)
        out = np.zeros((self.n_brows_pad * b, nb * b))
        bcols = self.bcols.cpu().numpy()
        bvals = self.bvals.double().cpu().numpy()
        blocks = out.reshape(self.n_brows_pad, b, nb, b)
        for s in range(self.kb):
            np.add.at(blocks, (np.arange(self.n_brows_pad), slice(None),
                               bcols[:, s]), bvals[:, s])
        return out[:self.n_rows, :self.n_cols]


def _tensor(arr: np.ndarray, dtype, device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(resolve_device(device))
    return t if dtype is None else t.to(torch_dtype(dtype))


def csr_to_ell(a: CsrHost, dtype=None, k: int | None = None,
               n_rows_pad: int | None = None, identity_pad_rows: bool = True,
               n_cols: int | None = None, device=None) -> EllMatrix:
    """Pack host CSR into padded ELL on ``device``.

    ``k`` (the width) defaults to the longest row, ``n_rows_pad`` to the
    row count rounded up to ``ROW_ALIGN``, ``n_cols`` to the matrix's.
    Every pad row is a zero row: the reference's ``identity_pad_rows``
    marks a square matrix's pad rows as identity rows only below
    ``n_cols``, which they never are, so the flag changes nothing and is
    taken for the reference's signature (a rectangular transfer, AMG's P
    and Pᵀ, passes its padded row count and False)."""
    m, n = a.shape
    if n_cols is not None:
        n = n_cols
    if k is None:
        k = max(a.max_row_length(), 1)
    if n_rows_pad is None:
        n_rows_pad = round_up(m, ROW_ALIGN)
    dtype = a.vals.dtype if dtype is None else dtype
    lens = a.row_lengths()
    if lens.max(initial=0) > k:
        raise ValueError(f"row length {lens.max()} exceeds ELL width {k}")
    cols = np.zeros((n_rows_pad, k), dtype=np.int64)
    vals = np.zeros((n_rows_pad, k), dtype=numpy_dtype(dtype))
    pos = np.arange(a.nnz) - np.repeat(a.row_ptr[:-1], lens)
    rows = a._rows()
    cols[rows, pos] = a.cols
    vals[rows, pos] = a.vals
    return EllMatrix(cols=_tensor(cols, None, device),
                     vals=_tensor(vals, dtype, device), n_rows=m, n_cols=n,
                     nnz=a.nnz)


def csr_to_bsr(a: CsrHost, block_size: int, dtype=None,
               device=None) -> BsrMatrix:
    """Pack host CSR into block-ELL with constant block size on ``device``.

    Any scalar nonzero makes its whole block present. A square matrix whose
    dimension is not a multiple of ``block_size`` is first extended with
    identity rows/cols. The block-row count is padded to a multiple of
    ``ROW_ALIGN // b`` (of 1 for b ≥ 8), as in the reference; padding block
    rows are identity blocks (zero blocks past ``n_cols``)."""
    b = block_size
    m, n = a.shape
    if m == n and m % b != 0:
        a = pad_csr_square(a, b)
        m, n = a.shape
    if m % b != 0 or n % b != 0:
        raise ValueError(f"BSR needs dims divisible by b={b}, got {a.shape}")
    mb, nb = m // b, n // b
    n_brows_pad = round_up(mb, max(ROW_ALIGN // min(b, ROW_ALIGN), 1))
    dtype = a.vals.dtype if dtype is None else dtype
    rows_rep = a._rows()
    brow = rows_rep // b
    bcol = a.cols.astype(np.int64) // b
    uniq_key, inv = np.unique(brow * nb + bcol, return_inverse=True)
    ub_row, ub_col = uniq_key // nb, uniq_key % nb
    blens = np.bincount(ub_row, minlength=mb)
    kb = max(int(blens.max(initial=0)), 1)
    bcols = np.zeros((n_brows_pad, kb), dtype=np.int64)
    bvals = np.zeros((n_brows_pad, kb, b, b), dtype=numpy_dtype(dtype))
    bptr = np.zeros(mb + 1, dtype=np.int64)
    np.cumsum(blens, out=bptr[1:])
    slot = np.arange(len(uniq_key)) - bptr[ub_row]
    bcols[ub_row, slot] = ub_col
    bvals[brow, slot[inv.reshape(-1)], rows_rep % b, a.cols % b] = a.vals
    if m == n:
        pad = np.arange(mb, n_brows_pad)
        bcols[pad, 0] = np.minimum(pad, nb - 1)
        bvals[pad[pad < nb], 0] = np.eye(b)
    return BsrMatrix(bcols=_tensor(bcols, None, device),
                     bvals=_tensor(bvals, dtype, device), block_size=b,
                     n_rows=m, n_cols=n, nnz=a.nnz)


def _n_diagonals(a: CsrHost) -> int:
    return len(np.unique(a.cols.astype(np.int64) - a._rows()))


def choose_format(a: CsrHost, block_size: int | None = None, dtype=None,
                  device=None):
    """Format selection at pack time (the reference's heuristic, which
    does not depend on the number of right-hand sides).

    With ``block_size`` > 1: at most 32 scalar diagonals → DIA; else at
    most 32 block offsets and dense fill → block DIA; else BSR. Without:
    few diagonals (≤ max(32, 2 × mean row length)) → DIA, else ELL."""
    if block_size is not None and block_size > 1:
        b = block_size
        if _n_diagonals(a) <= 32:
            return csr_to_dia(a, dtype=dtype, device=device)
        rows_rep = a._rows()
        boffs = np.unique(a.cols.astype(np.int64) // b - rows_rep // b)
        stored = len(boffs) * b * b * (a.shape[0] // b + 1)
        if len(boffs) <= 32 and a.nnz >= 0.35 * stored:
            return csr_to_bdia(a, b, dtype=dtype, device=device)
        return csr_to_bsr(a, b, dtype=dtype, device=device)
    avg_len = a.nnz / max(a.shape[0], 1)
    if _n_diagonals(a) <= max(32, 2 * avg_len):
        return csr_to_dia(a, dtype=dtype, device=device)
    return csr_to_ell(a, dtype=dtype, device=device)


def to_dense(m) -> np.ndarray:
    """Debug helper: the logical (unpadded) dense matrix of a device format,
    float64."""
    if isinstance(m, (EllMatrix, DiaMatrix, BsrMatrix, BdiaMatrix)):
        return m.to_dense()
    raise TypeError(f"to_dense: unsupported type {type(m).__name__}")
