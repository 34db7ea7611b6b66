"""The port's native (C++) host helpers: the AMG set-up's CSR SpGEMM, the
Matrix Market reader, the incomplete factorizations, the sparse direct
factorizations and the ghost-column ordering of the distributed
fillComplete.

Copies of functions of the JAX package's native library
(``trilinos_tpu/native/src/tt_native.cpp``), nothing else of it:
``tt_spgemm.cpp`` holds the two SpGEMM passes
(``tt_spgemm_count``/``tt_spgemm_fill``); ``tt_factor.cpp`` the Matrix
Market parser (``tt_read_mm_header``/``tt_read_mm``), ``tt_ilu0``,
``tt_ilut``, ``tt_iluk``, the sparse LU ``tt_splu`` and the sparse
Cholesky ``tt_spchol`` with their solves on many right-hand sides
(``tt_splu_solve_many``/``tt_spchol_solve_many``: each column by the
reference's one-column solve, the columns shared among the host's cores);
``tt_ghost.cpp`` the sorted ghost columns of a rank's boundary entries and
their slots (``tt_ghost_slots``). All three are compiled into one library with
``g++ -O3 -shared -fPIC`` at first use into ``trilinos_tpu_torch/_build/``
(git-ignored), keyed by a hash of every source and the flags, so an edit of
any rebuilds it, and loaded with ``ctypes``. Each build writes a file of
its own and renames it into place, so several processes may build at once.

Without ``g++`` the library is unavailable (:func:`lib` returns None) and
every wrapper here returns None: its caller takes the numpy/Python path of
the JAX package. The callers count which path served
(``spgemm.native_calls``/``numpy_calls``, ``read_sparse``,
``ilu0_factor``, ``ilut_factor``, ``iluk_pattern``, ``SparseLu`` and ``SparseCholesky``
each ``native_calls``/``python_calls``). A compiler that is present but
fails raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRC = (_HERE / "tt_spgemm.cpp", _HERE / "tt_factor.cpp",
        _HERE / "tt_ghost.cpp")
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def library_path() -> Path:
    digest = hashlib.sha256(b"".join(src.read_bytes() for src in _SRC)
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libtt_native-{digest[:16]}.so"


def build() -> Path | None:
    """Compile the library unless it is built; None when no ``g++``."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.{threading.get_ident()}")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp),
                           *map(str, _SRC)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed (rc {proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL | None:
    """The loaded library (built first if needed), or None without g++."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        path = build()
        _tried = True
        if path is None:
            return None
        lb = ctypes.CDLL(str(path))
        i64 = ctypes.c_int64

        def arr(t):
            return np.ctypeslib.ndpointer(t, flags="C_CONTIGUOUS")

        lb.tt_spgemm_count.restype = None
        lb.tt_spgemm_count.argtypes = [i64, i64, arr(np.int64),
                                       arr(np.int32), arr(np.int64),
                                       arr(np.int32), arr(np.int64)]
        lb.tt_spgemm_fill.restype = None
        lb.tt_spgemm_fill.argtypes = [
            i64, i64, arr(np.int64), arr(np.int32), arr(np.float64),
            arr(np.int64), arr(np.int32), arr(np.float64), arr(np.int64),
            arr(np.int32), arr(np.float64)]
        lb.tt_read_mm_header.restype = ctypes.c_int
        lb.tt_read_mm_header.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(i64), ctypes.POINTER(i64),
            ctypes.POINTER(i64), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(i64)]
        lb.tt_read_mm.restype = i64
        lb.tt_read_mm.argtypes = [ctypes.c_char_p, i64, i64, ctypes.c_int,
                                  arr(np.int64), arr(np.int64),
                                  arr(np.float64)]
        lb.tt_ilu0.restype = i64
        lb.tt_ilu0.argtypes = [i64, arr(np.int64), arr(np.int32),
                               arr(np.float64)]
        lb.tt_ilut.restype = i64
        lb.tt_ilut.argtypes = [
            i64, arr(np.int64), arr(np.int32), arr(np.float64),
            ctypes.c_double, ctypes.c_double, i64, arr(np.int64),
            arr(np.int32), arr(np.float64), arr(np.int64), arr(np.int32),
            arr(np.float64)]
        lb.tt_iluk.restype = i64
        lb.tt_iluk.argtypes = [i64, arr(np.int64), arr(np.int32), i64, i64,
                               arr(np.int64), arr(np.int32)]
        lb.tt_splu.restype = i64
        lb.tt_splu.argtypes = [
            i64, arr(np.int64), arr(np.int32), arr(np.float64), i64,
            arr(np.int64), arr(np.int32), arr(np.float64), arr(np.int64),
            arr(np.int32), arr(np.float64), arr(np.int64)]
        lb.tt_splu_solve_many.restype = None
        lb.tt_splu_solve_many.argtypes = [
            i64, i64, arr(np.int64), arr(np.int32), arr(np.float64),
            arr(np.int64), arr(np.int32), arr(np.float64), arr(np.int64),
            arr(np.float64), arr(np.float64), i64]
        lb.tt_spchol.restype = i64
        lb.tt_spchol.argtypes = [i64, arr(np.int64), arr(np.int32),
                                 arr(np.float64), i64, arr(np.int64),
                                 arr(np.int32), arr(np.float64)]
        lb.tt_spchol_solve_many.restype = None
        lb.tt_spchol_solve_many.argtypes = [
            i64, i64, arr(np.int64), arr(np.int32), arr(np.float64),
            arr(np.float64), arr(np.float64), i64]
        lb.tt_ghost_slots.restype = i64
        lb.tt_ghost_slots.argtypes = [i64, arr(np.int64), arr(np.int64),
                                      arr(np.int64)]
        _lib = lb
        return _lib


def spgemm_native(a, b):
    """(row_ptr, cols, vals) of C = A·B for CSR operands with ``row_ptr``,
    ``cols`` and ``vals`` (values in float64), or None without the
    library."""
    lb = lib()
    if lb is None:
        return None
    m, n = a.shape[0], b.shape[1]
    a_ptr = np.ascontiguousarray(a.row_ptr, np.int64)
    a_cols = np.ascontiguousarray(a.cols, np.int32)
    b_ptr = np.ascontiguousarray(b.row_ptr, np.int64)
    b_cols = np.ascontiguousarray(b.cols, np.int32)
    counts = np.zeros(m, np.int64)
    lb.tt_spgemm_count(m, n, a_ptr, a_cols, b_ptr, b_cols, counts)
    c_ptr = np.zeros(m + 1, np.int64)
    np.cumsum(counts, out=c_ptr[1:])
    c_cols = np.empty(int(c_ptr[-1]), np.int32)
    c_vals = np.empty(int(c_ptr[-1]), np.float64)
    lb.tt_spgemm_fill(m, n, a_ptr, a_cols,
                      np.ascontiguousarray(a.vals, np.float64), b_ptr,
                      b_cols, np.ascontiguousarray(b.vals, np.float64),
                      c_ptr, c_cols, c_vals)
    return c_ptr, c_cols, c_vals


def read_mm_native(path: str):
    """Parse a Matrix Market coordinate file (real, integer or pattern
    field). Returns (rows, cols, vals, shape, symm) with 0-based indices,
    symm 0 general, 1 symmetric, 2 skew-symmetric; None without the
    library or for a file the parser does not take (array format, complex
    or hermitian entries). A ``.gz`` file is decompressed to a temporary
    file first."""
    lb = lib()
    if lb is None:
        return None
    if str(path).endswith(".gz"):
        import gzip
        import tempfile

        with tempfile.NamedTemporaryFile(suffix=".mtx", delete=False) as tmp:
            try:
                with gzip.open(path, "rb") as src:
                    shutil.copyfileobj(src, tmp, length=1 << 20)
                tmp.flush()
                return read_mm_native(tmp.name)
            except OSError:
                return None
            finally:
                os.unlink(tmp.name)
    i64 = ctypes.c_int64
    m, n, nnz, pos = i64(), i64(), i64(), i64()
    symm, pattern = ctypes.c_int(), ctypes.c_int()
    if lb.tt_read_mm_header(str(path).encode(), m, n, nnz, symm, pattern,
                            pos) != 0:
        return None
    rows = np.empty(nnz.value, np.int64)
    cols = np.empty(nnz.value, np.int64)
    vals = np.empty(nnz.value, np.float64)
    got = lb.tt_read_mm(str(path).encode(), pos.value, nnz.value,
                        pattern.value, rows, cols, vals)
    if got != nnz.value:
        return None
    return rows, cols, vals, (m.value, n.value), symm.value


def ilu0_native(n: int, row_ptr: np.ndarray, cols: np.ndarray,
                vals: np.ndarray):
    """ILU(0) on a CSR whose rows are sorted by column: the factored values
    (L strictly left of the diagonal, unit diagonal implied; U from the
    diagonal on), or None without the library."""
    lb = lib()
    if lb is None:
        return None
    v = np.array(vals, dtype=np.float64)
    lb.tt_ilu0(n, np.ascontiguousarray(row_ptr, np.int64),
               np.ascontiguousarray(cols, np.int32), v)
    return v


def ilut_native(n: int, row_ptr: np.ndarray, cols: np.ndarray,
                vals: np.ndarray, fill: float, droptol: float):
    """ILUT(p, τ) on a sorted CSR: (l_ptr, l_cols, l_vals, u_ptr, u_cols,
    u_vals) with L strictly lower and each U row diagonal first, or None
    without the library. The output arrays grow until they hold the
    factors."""
    lb = lib()
    if lb is None:
        return None
    row_ptr = np.ascontiguousarray(row_ptr, np.int64)
    cols = np.ascontiguousarray(cols, np.int32)
    vals = np.ascontiguousarray(vals, np.float64)
    cap = max(int(int(row_ptr[-1]) * (fill + 1.0)) + 2 * n, 1024)
    for _ in range(8):
        l_ptr, u_ptr = np.zeros(n + 1, np.int64), np.zeros(n + 1, np.int64)
        l_cols, u_cols = np.zeros(cap, np.int32), np.zeros(cap, np.int32)
        l_vals, u_vals = np.zeros(cap), np.zeros(cap)
        r = lb.tt_ilut(n, row_ptr, cols, vals, float(fill), float(droptol),
                       cap, l_ptr, l_cols, l_vals, u_ptr, u_cols, u_vals)
        if r >= 0:
            return (l_ptr, l_cols[:l_ptr[n]], l_vals[:l_ptr[n]],
                    u_ptr, u_cols[:u_ptr[n]], u_vals[:u_ptr[n]])
        cap = max(int(-r) * 2, cap * 2)
    raise RuntimeError("tt_ilut: fill capacity retry limit exceeded")


def iluk_native(n: int, row_ptr: np.ndarray, cols: np.ndarray, kfill: int):
    """The ILU(k) level-of-fill pattern (row_ptr, cols) of a sorted CSR
    pattern, or None without the library."""
    lb = lib()
    if lb is None:
        return None
    row_ptr = np.ascontiguousarray(row_ptr, np.int64)
    cols = np.ascontiguousarray(cols, np.int32)
    cap = max(int(row_ptr[-1]) * (kfill + 2), 16)
    out_ptr = np.empty(n + 1, np.int64)
    out_cols = np.empty(cap, np.int32)
    need = lb.tt_iluk(n, row_ptr, cols, kfill, cap, out_ptr, out_cols)
    if need > cap:  # out_ptr is complete: the second call fits exactly
        out_cols = np.empty(int(need), np.int32)
        need = lb.tt_iluk(n, row_ptr, cols, kfill, int(need), out_ptr,
                          out_cols)
    return out_ptr, out_cols[:need]


# fill-capacity retries of the two-call protocol (the JAX package's limit)
_RETRIES = 8


def splu_native(n, row_ptr, cols, vals):
    """Sparse LU (Gilbert-Peierls, partial pivoting) of an n×n CSR.

    Returns (l_ptr, l_cols, l_vals, u_ptr, u_cols, u_vals, perm), or None
    without the library. L and U are column-major: L column j holds
    original-row multipliers (unit diagonal implied); U column j holds
    pivot-position rows with the diagonal last; perm[k] is the original row
    in pivot position k. The output arrays grow until they hold the
    factors (at most ``_RETRIES`` calls)."""
    lb = lib()
    if lb is None:
        return None
    row_ptr = np.ascontiguousarray(row_ptr, np.int64)
    cols = np.ascontiguousarray(cols, np.int32)
    vals = np.ascontiguousarray(vals, np.float64)
    cap = max(int(row_ptr[-1]) * 8, 16 * n, 1024)
    for _ in range(_RETRIES):
        l_ptr, u_ptr = np.zeros(n + 1, np.int64), np.zeros(n + 1, np.int64)
        l_cols, u_cols = np.zeros(cap, np.int32), np.zeros(cap, np.int32)
        l_vals, u_vals = np.zeros(cap), np.zeros(cap)
        perm = np.zeros(n, np.int64)
        r = lb.tt_splu(n, row_ptr, cols, vals, cap, l_ptr, l_cols, l_vals,
                       u_ptr, u_cols, u_vals, perm)
        if r >= 0:
            return (l_ptr, l_cols[:l_ptr[n]], l_vals[:l_ptr[n]],
                    u_ptr, u_cols[:u_ptr[n]], u_vals[:u_ptr[n]], perm)
        cap = max(int(-r) * 2, cap * 2)
    raise RuntimeError("tt_splu: fill capacity retry limit exceeded")


def _many(solve, n, b):
    """solve(k, rows, out) on b's columns as rows of a (k, n) array; x in
    b's shape, (n,) or (n, k)."""
    b = np.asarray(b, np.float64)
    rows = np.ascontiguousarray(b.reshape(n, -1).T)
    out = np.empty_like(rows)
    solve(rows.shape[0], rows, out)
    return out[0] if b.ndim == 1 else out.T


def splu_solve_native(factors, b):
    """x with A x = b from :func:`splu_native`'s factors, for b of shape
    (n,) or (n, k), or None without the library."""
    lb = lib()
    if lb is None:
        return None
    l_ptr, l_cols, l_vals, u_ptr, u_cols, u_vals, perm = factors
    n = len(perm)
    return _many(lambda k, rows, out: lb.tt_splu_solve_many(
        n, k, l_ptr, l_cols, l_vals, u_ptr, u_cols, u_vals, perm, rows, out,
        os.cpu_count() or 1), n, b)


class NotSpdError(ValueError):
    """tt_spchol found a non-positive reduced diagonal."""


def spchol_native(n, row_ptr, cols, vals):
    """Sparse Cholesky LL^T (up-looking, elimination tree) of an n×n CSR
    whose lower triangle is read. Returns (l_ptr, l_cols, l_vals), CSC with
    the diagonal first in each column, or None without the library; raises
    :class:`NotSpdError` when the matrix is not positive definite."""
    lb = lib()
    if lb is None:
        return None
    row_ptr = np.ascontiguousarray(row_ptr, np.int64)
    cols = np.ascontiguousarray(cols, np.int32)
    vals = np.ascontiguousarray(vals, np.float64)
    cap = max(int(row_ptr[-1]) * 4, 8 * n, 1024)
    for _ in range(_RETRIES):
        l_ptr = np.zeros(n + 1, np.int64)
        l_cols, l_vals = np.zeros(cap, np.int32), np.zeros(cap)
        r = lb.tt_spchol(n, row_ptr, cols, vals, cap, l_ptr, l_cols, l_vals)
        if r >= 0:
            return l_ptr, l_cols[:r], l_vals[:r]
        if -r >= 10 ** 15:
            raise NotSpdError(
                f"tt_spchol: non-positive pivot at column {-r - 10 ** 15} "
                "(matrix not symmetric positive definite)")
        cap = max(int(-r) * 2, cap * 2)
    raise RuntimeError("tt_spchol: fill capacity retry limit exceeded")


def spchol_solve_native(factors, b):
    """x with A x = b from :func:`spchol_native`'s factor, for b of shape
    (n,) or (n, k), or None without the library."""
    lb = lib()
    if lb is None:
        return None
    l_ptr, l_cols, l_vals = factors
    n = len(l_ptr) - 1
    return _many(lambda k, rows, out: lb.tt_spchol_solve_many(
        n, k, l_ptr, l_cols, l_vals, rows, out, os.cpu_count() or 1), n, b)


def ghost_slots_native(bc_cols: np.ndarray):
    """Sorted unique ghost gids and each entry's slot among them for one
    rank's boundary columns (contiguous maps: owner-major order is gid
    order). Returns (ghost_gids, slots), or None without the library."""
    lb = lib()
    if lb is None:
        return None
    bc = np.ascontiguousarray(bc_cols, np.int64)
    nb = len(bc)
    if nb == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    gids = np.empty(nb, np.int64)
    slots = np.empty(nb, np.int64)
    ng = lb.tt_ghost_slots(nb, bc, gids, slots)
    return gids[:ng], slots
