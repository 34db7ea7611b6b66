"""ILU(k) with fixed-sweep Jacobi triangular solves.

Counterpart of ``trilinos_tpu/precond/ilu.py`` (the analogue of
Ifpack2::RILUK, Ifpack2_RILUK_decl.hpp:243): ``iluk_pattern`` is the
level-of-fill graph (IlukGraph; the port's native ``tt_iluk``, or the
same row merge in Python), fill level k > 0 runs ILU(0) numerics on the
level-k-augmented pattern, and RBILUK ("fact: block size" > 1) runs them on
the dense-block pattern of the block graph. The numeric factorization is
host code (the port's native ``tt_ilu0``, or the Python IKJ sweep).

The apply keeps the reference's algorithm: a fixed number of Jacobi sweeps
on each triangular factor (the FastILU strategy), not an exact triangular
solve. A fixed sweep count keeps the preconditioner linear, so it is safe
inside CG and GMRES. The factors are packed with ``choose_format``: DIA on
a stencil matrix, so every sweep is one DIA SpMV (SpMM for a block) on the
card's kernel.
"""
from __future__ import annotations

import heapq

import numpy as np
import torch

from ..device import resolve_device, torch_dtype
from ..native import ilu0_native, iluk_native
from ..ops.formats import ROW_ALIGN, CsrHost, choose_format, round_up
from ..ops.matvec import spmv
from ..utils.params import Param
from .base import Preconditioner

_SPECS = {
    "fact: sweeps": Param("fact: sweeps", 6,
                          doc="Jacobi sweeps per triangular solve"),
    "fact: iluk level-of-fill": Param(
        "fact: iluk level-of-fill", 0,
        doc="ILU(k) fill level (Ifpack2::RILUK parameter): the numeric "
            "factor runs on the level-k-augmented pattern"),
    "fact: block size": Param(
        "fact: block size", 1,
        doc="b > 1 → RBILUK: block-level ILU(k) on the BSR block graph "
            "(Ifpack2::Experimental::RBILUK)"),
    "dtype": Param("dtype", None),
}


def iluk_pattern(a: CsrHost, kfill: int):
    """ILU(k) symbolic level-of-fill pattern (Ifpack2::IlukGraph,
    packages/ifpack2/src/Ifpack2_IlukGraph.hpp). Returns (row_ptr, cols)
    of the augmented pattern. Native C++ fast path (tt_iluk); the Python
    fallback is the same row-merge algorithm with a heap standing in for
    the ordered working set."""
    n = a.shape[0]
    out = iluk_native(n, a.row_ptr, a.cols, int(kfill))
    if out is not None:
        iluk_pattern.native_calls += 1
        return out
    iluk_pattern.python_calls += 1

    ABSENT = -1
    lev = np.full(n, ABSENT, dtype=np.int64)
    u_cols: list[np.ndarray] = []
    u_levs: list[np.ndarray] = []
    out_ptr = np.zeros(n + 1, np.int64)
    out_cols: list[np.ndarray] = []
    for i in range(n):
        ci = a.cols[a.row_ptr[i]:a.row_ptr[i + 1]].astype(np.int64)
        heap = list(ci)
        heapq.heapify(heap)
        lev[ci] = 0
        seen = []
        while heap:
            k = heapq.heappop(heap)
            if seen and k == seen[-1]:
                continue  # duplicate push
            seen.append(k)
            if k >= i:
                continue
            lk = lev[k]
            for j, lj in zip(u_cols[k], u_levs[k]):
                nl = lk + lj + 1
                if nl <= kfill:
                    if lev[j] == ABSENT:
                        lev[j] = nl
                        heapq.heappush(heap, int(j))
                    elif nl < lev[j]:
                        lev[j] = nl
        row = np.asarray(seen, dtype=np.int64)
        out_cols.append(row)
        out_ptr[i + 1] = out_ptr[i] + len(row)
        up = row[row > i]
        u_cols.append(up)
        u_levs.append(lev[up].copy())
        lev[row] = ABSENT
    return out_ptr, np.concatenate(out_cols) if out_cols else np.zeros(
        0, np.int64)


iluk_pattern.native_calls = 0
iluk_pattern.python_calls = 0


def _scatter_positions(rows_pat, cols_pat, a: CsrHost) -> np.ndarray:
    """Positions of A's entries inside a superset pattern (both
    row-major sorted): ONE vectorized searchsorted over the combined
    (row, col) keys — replaces a per-row Python loop on the setup
    path."""
    ncp1 = a.shape[1] + 1
    keys_pat = rows_pat * ncp1 + cols_pat.astype(np.int64)
    rows_a = np.repeat(np.arange(a.shape[0], dtype=np.int64),
                       a.row_lengths())
    keys_a = rows_a * ncp1 + a.cols.astype(np.int64)
    return np.searchsorted(keys_pat, keys_a)


def iluk_augment(a: CsrHost, kfill: int) -> CsrHost:
    """A with EXPLICIT ZEROS at the ILU(k) fill positions: ILU(0) numeric
    factorization on this pattern IS ILU(k) — the classical reduction."""
    if kfill <= 0:
        return a
    ptr, cols = iluk_pattern(a, kfill)
    n = a.shape[0]
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))
    vals = np.zeros(len(cols), dtype=a.vals.dtype)
    vals[_scatter_positions(rows, cols, a)] = a.vals
    return CsrHost.from_coo(rows, cols.astype(np.int64), vals, a.shape,
                            sum_duplicates=False)


def rbiluk_augment(a: CsrHost, block_size: int, kfill: int = 0) -> CsrHost:
    """RBILUK pattern (Ifpack2::Experimental::RBILUK,
    packages/ifpack2/src/Ifpack2_Experimental_RBILUK_decl.hpp): block-
    level ILU(k) on the BSR block graph. Reduction used here: block LU
    without pivoting equals SCALAR LU on the dense-block pattern, so the
    factorization is (1) block graph of A, (2) level-k fill on the BLOCK
    graph (``iluk_pattern``), (3) expand every kept block to a dense
    b×b scalar patch (A's values where present, explicit zeros at fill),
    (4) scalar ILU(0) numerics on that pattern."""
    b = int(block_size)
    n = a.shape[0]
    if b <= 1:
        return iluk_augment(a, kfill)
    if n % b:
        raise ValueError(f"matrix order {n} not a multiple of block "
                         f"size {b}")
    nb = n // b
    rows_rep = np.repeat(np.arange(n, dtype=np.int64), a.row_lengths())
    bkey = (rows_rep // b) * nb + a.cols.astype(np.int64) // b
    bkey = np.unique(bkey)
    brows, bcols_ = bkey // nb, bkey % nb
    bptr = np.zeros(nb + 1, np.int64)
    np.add.at(bptr, brows + 1, 1)
    bptr = np.cumsum(bptr)
    bgraph = CsrHost(bptr, bcols_.astype(np.int32),
                     np.ones(len(bcols_)), (nb, nb))
    if kfill > 0:
        bptr, bcols_ = iluk_pattern(bgraph, kfill)
        bcols_ = bcols_.astype(np.int64)
    # expand each block to a dense b×b scalar patch
    nblk = len(bcols_)
    blk_rows = np.repeat(np.repeat(np.arange(nb), np.diff(bptr)), b * b)
    blk_cols = np.repeat(bcols_, b * b)
    ii = np.tile(np.repeat(np.arange(b), b), nblk)
    jj = np.tile(np.tile(np.arange(b), b), nblk)
    rows_s = blk_rows * b + ii
    cols_s = blk_cols * b + jj
    pattern = CsrHost.from_coo(rows_s, cols_s,
                               np.zeros(len(rows_s), dtype=a.vals.dtype),
                               a.shape, sum_duplicates=False)
    vals = pattern.vals.copy()
    rows_pat = np.repeat(np.arange(n, dtype=np.int64),
                         np.diff(pattern.row_ptr))
    vals[_scatter_positions(rows_pat, pattern.cols, a)] = a.vals
    return CsrHost(pattern.row_ptr, pattern.cols, vals, a.shape)


def ilu0_factor(a: CsrHost) -> tuple[CsrHost, CsrHost]:
    """Classic IKJ ILU(0): returns (L unit-lower incl. diag=1, U upper).

    Fast path: the port's native C++ factorization
    (``ilu0_factor.native_calls``); the Python sweep below serves without
    the library, or for unsorted rows (``ilu0_factor.python_calls``)."""
    n = a.shape[0]
    # the native kernel requires column-sorted rows (CsrHost.from_coo
    # guarantees this; verify cheaply before trusting it)
    rows_rep_chk = np.repeat(np.arange(n), a.row_lengths())
    keys = rows_rep_chk.astype(np.int64) * (a.shape[1] + 1) + a.cols
    sorted_ok = bool(np.all(np.diff(keys) > 0)) if len(keys) else True
    fv = ilu0_native(n, a.row_ptr, a.cols, a.vals) if sorted_ok else None
    if fv is not None:
        ilu0_factor.native_calls += 1
        rows_rep = np.repeat(np.arange(n), a.row_lengths())
        lower = a.cols < rows_rep
        upper = ~lower
        diag_rows = np.arange(n)
        l_m = CsrHost.from_coo(
            np.concatenate([rows_rep[lower], diag_rows]),
            np.concatenate([a.cols[lower].astype(np.int64), diag_rows]),
            np.concatenate([fv[lower], np.ones(n)]), a.shape,
            sum_duplicates=False)
        u_m = CsrHost.from_coo(rows_rep[upper],
                               a.cols[upper].astype(np.int64), fv[upper],
                               a.shape, sum_duplicates=False)
        return l_m, u_m
    ilu0_factor.python_calls += 1
    # copy values into a row-indexed dict-of-rows for the sequential sweep
    row_cols = []
    row_vals = []
    for i in range(n):
        c, v = a.row(i)
        order = np.argsort(c)
        row_cols.append(c[order].astype(np.int64))
        row_vals.append(v[order].astype(np.float64).copy())
    col_pos = [dict(zip(rc.tolist(), range(len(rc)))) for rc in row_cols]
    for i in range(n):
        ci, vi = row_cols[i], row_vals[i]
        for kk in range(len(ci)):
            k = ci[kk]
            if k >= i:
                break
            ukk_pos = col_pos[k].get(k)
            if ukk_pos is None:
                continue
            ukk = row_vals[k][ukk_pos]
            if ukk == 0:
                continue
            vi[kk] = lik = vi[kk] / ukk
            # update row i against row k's upper part, pattern-restricted
            ck, vk = row_cols[k], row_vals[k]
            for jj in range(ukk_pos + 1, len(ck)):
                pos = col_pos[i].get(ck[jj])
                if pos is not None:
                    vi[pos] -= lik * vk[jj]
    # split into L (strict lower + unit diag) and U (diag + upper)
    lr, lc, lv, ur, uc, uv = [], [], [], [], [], []
    for i in range(n):
        ci, vi = row_cols[i], row_vals[i]
        lower = ci < i
        upper = ci >= i
        lr.append(np.full(lower.sum() + 1, i))
        lc.append(np.concatenate([ci[lower], [i]]))
        lv.append(np.concatenate([vi[lower], [1.0]]))
        ur.append(np.full(upper.sum(), i))
        uc.append(ci[upper])
        uv.append(vi[upper])
    l_m = CsrHost.from_coo(np.concatenate(lr), np.concatenate(lc),
                           np.concatenate(lv), a.shape, sum_duplicates=False)
    u_m = CsrHost.from_coo(np.concatenate(ur), np.concatenate(uc),
                           np.concatenate(uv), a.shape, sum_duplicates=False)
    return l_m, u_m


ilu0_factor.native_calls = 0
ilu0_factor.python_calls = 0


def triangular_sweeps(l, u, udinv: torch.Tensor, sweeps: int,
                      r: torch.Tensor) -> torch.Tensor:
    """x ≈ U⁻¹ L⁻¹ r by a fixed number of Jacobi sweeps on each factor
    (L unit lower, U upper with inverse diagonal ``udinv``): a linear
    operator, the same sweeps for ILU(k) and ILUT."""
    d = udinv if r.ndim == 1 else udinv[:, None]
    # L y = r, L unit-diagonal: y ← r − (L − I) y
    y = r
    for _ in range(sweeps):
        y = r - (spmv(l, y) - y)
    # U x = y: x ← D_U⁻¹ (y − (U − D_U) x)
    x = d * y
    for _ in range(sweeps):
        x = x + d * (y - spmv(u, x))
    return x


def pack_factors(l_m: CsrHost, u_m: CsrHost, dtype, device):
    """(L, U, padded inverse diagonal of U) on ``device``: each factor
    through ``choose_format`` (DIA on a stencil matrix, so the sweeps run
    the DIA kernel on the card)."""
    n = l_m.shape[0]
    du = u_m.diagonal().astype(np.float64)
    dinv = np.ones(round_up(n, ROW_ALIGN))
    dinv[:n] = 1.0 / np.where(du != 0, du, 1.0)
    return (choose_format(l_m, dtype=dtype, device=device),
            choose_format(u_m, dtype=dtype, device=device),
            torch.from_numpy(dinv).to(device, torch_dtype(dtype)))


class Ilu0(Preconditioner):
    """ILU(k) (RILUK; RBILUK with "fact: block size" > 1): the factors of
    the level-k (block-)augmented pattern, applied by fixed Jacobi sweeps.
    ``device`` places the factors (``None``: the CUDA card)."""

    def __init__(self, a, params=None, device=None):
        super().__init__(a, params)
        self.device = resolve_device(device)

    def _do_initialize(self) -> None:
        self.params.validate(_SPECS)
        if not isinstance(self.a, CsrHost):
            raise TypeError("Ilu0 expects a CsrHost matrix")

    def _do_compute(self) -> None:
        dtype = self.params["dtype"] or self.a.vals.dtype
        lof = int(self.params["fact: iluk level-of-fill"])
        bs = int(self.params["fact: block size"])
        aug = (rbiluk_augment(self.a, bs, lof) if bs > 1
               else iluk_augment(self.a, lof))
        self.set_state(*pack_factors(*ilu0_factor(aug), dtype, self.device),
                       int(self.params["fact: sweeps"]))

    def set_state(self, l, u, udinv: torch.Tensor, sweeps: int) -> None:
        """Take the factors, U's padded inverse diagonal and the sweep
        count as they are (``convert.ilu_from_numpy`` carries the JAX
        package's in)."""
        self._l, self._u, self._udinv, self.sweeps = l, u, udinv, sweeps
        self._computed = True

    def _apply(self, r: torch.Tensor) -> torch.Tensor:
        return triangular_sweeps(self._l, self._u, self._udinv, self.sweeps,
                                 r)
