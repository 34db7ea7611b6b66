"""Stored-DIA SpMV: plain PyTorch version and the CUDA kernel wrapper.

Counterpart of the XLA DIA apply in ``trilinos_tpu/ops/matvec.py``
(``dia_spmm``, ``dia_spmm_t``) and of the TPU kernels in
``trilinos_tpu/ops/pallas/dia_spmv.py``.

Kernel: ``csrc/dia_spmv.cu`` replaces ``dia_spmm_ring`` for one right-hand
side and the window kernel ``dia_spmv_pallas``. On an H100 it is bound by
bytes: (nd·itemsize(data) + 2·itemsize(x))·n_pad over 3.35 TB/s. One
thread per row loops over the diagonals (coalesced ``data[d, :]`` reads);
each block reads its own x neighbourhood, since GPU blocks share no
scratch across steps the way the TPU ring kernel's grid steps did.

The multivector apply (x of shape (n_pad, k), row-major) is the same
file's ``dia_mv_kernel``: it replaces ``dia_spmm_ring`` at k > 1 and the
window kernel ``dia_spmm_packed``. Bound by bytes, (nd·itemsize(data) +
2·k·itemsize(x))·n_pad. A thread owns vw adjacent columns of one row and
moves them as one load of X and one store of Y (16 bytes where k and the
pointers allow it), reading ``data[d, i]`` once for its vw columns.
:func:`dia_spmm_plan` picks vw and the launch on the host; the launcher
checks it. Same diagonal order and rounding as the plain version, so the
result is bitwise its.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from . import _build
from .autodiff import linear_apply
from .dispatch import use_kernel
from .formats import DiaMatrix
from .stencil_op import VEC_BYTES, pointer_align

MAX_DIAGS = 512  # csrc/dia_spmv.cu TT_MAX_DIAGS

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = [_P, _P, _P, ctypes.c_longlong, _I, _P, _P]
_SIG_MV = _SIG[:4] + [_I] + _SIG[4:6] + [_P, _P]  # k; the plan, the stream
_TYPES = {(torch.float32, torch.float32): "f32",
          (torch.float64, torch.float64): "f64",
          (torch.bfloat16, torch.float32): "bf16f32"}
MAX_COLS = 1024  # csrc/dia_spmv.cu TT_MAX_COLS
MV_THREADS = 256  # about this many threads in a SpMM block


@dataclasses.dataclass(frozen=True)
class DiaSpmmPlan:
    """Launch of the DIA SpMM kernel: ``vw`` columns of one row a thread,
    a block of (k / vw, block[1], 1) threads over block[1] consecutive
    rows, grid[0] blocks."""

    vw: int
    block: tuple[int, int, int]
    grid: tuple[int, int, int]

    def fields(self) -> np.ndarray:
        """The int32 array the C launcher reads."""
        return np.asarray([self.vw, *self.block, *self.grid], dtype=np.int32)


def dia_spmm_plan(n_pad: int, k: int, itemsize: int,
                  align: int = VEC_BYTES) -> DiaSpmmPlan:
    """The SpMM kernel's launch for X of shape (n_pad, k) with elements of
    ``itemsize`` bytes whose pointers (X's and Y's) are multiples of
    ``align`` bytes: vw is the widest of 16, 8, 4 bytes (then one element)
    that divides the row and the alignment, as the stencil SpMM's
    :func:`~.stencil_op.spmm_plan` picks it, and a block takes about
    MV_THREADS threads (at least one row of k / vw lanes, at most 1024
    along each axis)."""
    if not 1 <= k <= MAX_COLS:
        raise ValueError(f"DIA SpMM takes 1 ≤ k ≤ {MAX_COLS}, got {k}")
    vw = VEC_BYTES // itemsize
    while vw > 1 and (k % vw or align % (vw * itemsize)):
        vw //= 2
    lanes = k // vw
    by = max(1, MV_THREADS // lanes)
    return DiaSpmmPlan(vw=vw, block=(lanes, by, 1),
                       grid=(-(-n_pad // by), 1, 1))


def _as_2d(a: DiaMatrix, x: torch.Tensor):
    x2 = x[:, None] if x.ndim == 1 else x
    if x2.shape[0] != a.n_rows_pad:
        raise ValueError(f"DIA spmv: x length {x2.shape[0]} != padded rows "
                         f"{a.n_rows_pad}")
    y = torch.zeros(x2.shape, dtype=torch.promote_types(a.dtype, x.dtype),
                    device=x.device)
    return x2, y


def dia_spmv_plain(a: DiaMatrix, x: torch.Tensor) -> torch.Tensor:
    """Plain y[i] = Σ_d data[d,i]·x[i+off_d] by rolls (exact, because
    out-of-range positions store zeros); x is (n_pad,) or (n_pad, k)."""
    x2, y = _as_2d(a, x)
    for d, off in enumerate(a.offsets):
        shifted = torch.roll(x2, -off, dims=0) if off else x2
        y = y + a.data[d][:, None] * shifted
    return y[:, 0] if x.ndim == 1 else y


def dia_spmv_t_plain(a: DiaMatrix, x: torch.Tensor) -> torch.Tensor:
    """Transpose apply: yᵀ[j] = Σ_d data[d, j − o_d] · x[j − o_d]."""
    x2, y = _as_2d(a, x)
    for d, off in enumerate(a.offsets):
        term = a.data[d][:, None] * x2
        y = y + (torch.roll(term, off, dims=0) if off else term)
    return y[:, 0] if x.ndim == 1 else y


@functools.lru_cache(maxsize=64)
def _offsets(offsets: tuple[int, ...]) -> np.ndarray:
    return np.asarray(offsets, dtype=np.int32)


def _launch(kind: str, a: DiaMatrix, x: torch.Tensor) -> torch.Tensor:
    """Checks shared by both kernels, then one launch of
    ``dia_<kind>_<types>`` (the SpMM with k and its plan)."""
    types = _TYPES.get((a.dtype, x.dtype))
    if types is None:
        raise TypeError(f"DIA kernel takes f32/f32, f64/f64 or bf16/f32 "
                        f"data/x, got {a.dtype}/{x.dtype}")
    if not (x.is_contiguous() and a.data.is_contiguous()):
        raise ValueError("DIA kernel takes contiguous data and x")
    if a.data.device != x.device:
        raise ValueError(f"DIA data on {a.data.device}, x on {x.device}")
    if len(a.offsets) > MAX_DIAGS:
        raise ValueError(f"DIA kernel takes ≤ {MAX_DIAGS} diagonals, got "
                         f"{len(a.offsets)}")
    lib = _build.load("dia_spmv", {
        f"dia_{kd}_{t}": sig for kd, sig in (("spmv", _SIG),
                                              ("spmm", _SIG_MV))
        for t in _TYPES.values()})
    offs = _offsets(a.offsets)
    y = torch.empty_like(x)
    cols, plan = (), ()
    if kind == "spmm":
        k = x.shape[1]
        fields = dia_spmm_plan(a.n_rows_pad, k, x.element_size(),
                               pointer_align(x, y)).fields()
        cols, plan = (k,), (fields.ctypes.data,)  # fields alive for the call
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, f"dia_{kind}_{types}")(
            a.data.data_ptr(), x.data_ptr(), y.data_ptr(), a.n_rows_pad,
            *cols, len(a.offsets), offs.ctypes.data, *plan, stream)
    _build.check(lib, rc, f"dia_{kind}")
    return y


def _spmv_raw(a: DiaMatrix, x: torch.Tensor) -> torch.Tensor:
    """The forward of :func:`dia_spmv`: one launch or the plain version."""
    if not use_kernel(x):
        return dia_spmv_plain(a, x)
    if x.ndim != 1 or x.shape[0] != a.n_rows_pad:
        raise ValueError(f"DIA kernel takes x of shape ({a.n_rows_pad},) or "
                         f"({a.n_rows_pad}, k), got {tuple(x.shape)}")
    y = _launch("spmv", a, x)
    dia_spmv.launches += 1
    return y


def _spmm_raw(a: DiaMatrix, x: torch.Tensor) -> torch.Tensor:
    """The forward of :func:`dia_spmm`: one launch or the plain version."""
    if not use_kernel(x):
        return dia_spmv_plain(a, x)
    if x.ndim != 2 or x.shape[0] != a.n_rows_pad or not (
            1 <= x.shape[1] <= MAX_COLS):
        raise ValueError(f"DIA SpMM kernel takes X of shape "
                         f"({a.n_rows_pad}, k), 1 ≤ k ≤ {MAX_COLS}, got "
                         f"{tuple(x.shape)}")
    y = _launch("spmm", a, x)
    dia_spmm.launches += 1
    return y


def dia_spmv(a: DiaMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A·x for x of shape (n_pad,) or (n_pad, k): the CUDA kernel for a
    CUDA tensor, the plain version for a CPU tensor. A 2-D x goes to
    :func:`dia_spmm`. Differentiable in x (``ops/autodiff.py``): the JVP
    applies A to the tangent through the kernel, the VJP is
    :func:`dia_spmv_t_plain` (the JAX package's transpose is XLA too).
    ``dia_spmv.launches`` counts launches of the single-vector kernel."""
    if x.ndim == 2:
        return dia_spmm(a, x)
    return linear_apply(_spmv_raw, dia_spmv_t_plain, a, x)


def dia_spmm(a: DiaMatrix, x: torch.Tensor) -> torch.Tensor:
    """Y = A·X for X of shape (n_pad, k), k ≥ 1, row-major: the CUDA kernel
    for a CUDA tensor, the plain version for a CPU tensor; differentiable
    in X as :func:`dia_spmv`. ``dia_spmm.launches`` counts kernel
    launches."""
    return linear_apply(_spmm_raw, dia_spmv_t_plain, a, x)


dia_spmv.launches = 0
dia_spmm.launches = 0
