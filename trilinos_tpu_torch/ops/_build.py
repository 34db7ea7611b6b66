"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. A build
happens at first use, into ``trilinos_tpu_torch/_build/`` (git-ignored),
keyed by a hash of the source, the shared headers ``csrc/*.cuh`` and the
flags, so an edited source or header is rebuilt and an unchanged one is
reused. A missing ``nvcc`` is an error.

Each C entry point returns the ``cudaError_t`` of its launch (0 = success)
and each library exports ``tt_error_string`` to name it.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNELS = ("stencil_spmv", "dia_spmv", "chol_inv_small", "stencil_poly",
           "cg_fused", "bdia_spmv")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be "
                       "built")


def library_path(name: str) -> Path:
    src = b"".join(p.read_bytes() for p in (
        CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=KERNELS) -> dict[str, float]:
    """Compile every library of ``names`` that is not built yet, all nvcc
    processes started together. Returns seconds per library built; the
    compiler's register report goes to ``_build/<name>.log``."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = library_path(n)
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        procs[n] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    secs = {}
    failed = []
    for n, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        secs[n] = time.perf_counter() - t0
        (BUILD_DIR / f"{n}.log").write_text(log)
        if p.returncode != 0:
            failed.append(f"{n} (rc {p.returncode}):\n{log}")
            with contextlib.suppress(FileNotFoundError):
                tmp.unlink()
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return secs


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Load (building first if needed) ``lib<name>``; ``signatures`` maps
    each C function to its argtypes (restype is int, the cudaError_t)."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        lib.tt_error_string.argtypes = [ctypes.c_int]
        lib.tt_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{what}: CUDA error {rc} ({lib.tt_error_string(rc).decode()})")
