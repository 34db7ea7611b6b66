"""The port's native (C++) host helper: CSR SpGEMM for the AMG set-up.

``tt_spgemm.cpp`` holds the two passes of the JAX package's native SpGEMM
(``tt_spgemm_count``/``tt_spgemm_fill``), copied and nothing else of that
library. It is compiled with ``g++ -O3 -shared -fPIC`` at first use into
``trilinos_tpu_torch/_build/`` (git-ignored), keyed by a hash of the source
and the flags, and loaded with ``ctypes``. Each build writes a file of its
own and renames it into place, so several processes may build at once.

Without ``g++`` the library is unavailable (:func:`lib` returns None) and
``ops.matrix_ops.spgemm`` takes its numpy path, as the JAX package does;
``spgemm.native_calls``/``spgemm.numpy_calls`` tell which path served. A
compiler that is present but fails raises.
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

_SRC = Path(__file__).resolve().parent / "tt_spgemm.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libtt_spgemm-{digest[:16]}.so"


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
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(_SRC)],
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
