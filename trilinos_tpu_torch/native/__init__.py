"""The port's native (C++) host helpers: the AMG set-up's CSR SpGEMM, the
Matrix Market reader and the incomplete factorizations.

Copies of functions of the JAX package's native library
(``trilinos_tpu/native/src/tt_native.cpp``), nothing else of it:
``tt_spgemm.cpp`` holds the two SpGEMM passes
(``tt_spgemm_count``/``tt_spgemm_fill``); ``tt_factor.cpp`` the Matrix
Market parser (``tt_read_mm_header``/``tt_read_mm``), ``tt_ilu0``,
``tt_ilut`` and ``tt_iluk``. Both are compiled into one library with
``g++ -O3 -shared -fPIC`` at first use into ``trilinos_tpu_torch/_build/``
(git-ignored), keyed by a hash of every source and the flags, so an edit of
either rebuilds it, and loaded with ``ctypes``. Each build writes a file of
its own and renames it into place, so several processes may build at once.

Without ``g++`` the library is unavailable (:func:`lib` returns None) and
every wrapper here returns None: its caller takes the numpy/Python path of
the JAX package. The callers count which path served
(``spgemm.native_calls``/``numpy_calls``, ``read_sparse``,
``ilu0_factor``, ``ilut_factor`` and ``iluk_pattern`` each
``native_calls``/``python_calls``). A compiler that is present but fails
raises.
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
_SRC = (_HERE / "tt_spgemm.cpp", _HERE / "tt_factor.cpp")
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

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
