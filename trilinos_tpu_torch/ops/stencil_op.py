"""Matrix-free constant-coefficient stencil operator and its SpMV kernel.

Counterpart of ``trilinos_tpu/ops/pallas/stencil_op.py``. A Galeri
stencil with constant coefficients needs no stored matrix: the values are
a handful of scalars and the truncation at the grid faces follows from
the row's grid coordinates.

Kernel: ``csrc/stencil_spmv.cu`` replaces the TPU kernels
``stencil_spmv_planes`` (``_plane_kernel``) and ``stencil_spmv_masked``
(``_dma_kernel``). It reads x and writes y once each, so on an H100 it is
bound by bytes: 2·n·itemsize over 3.35 TB/s (≈ 0.040 ms for 256³ f32).
The TPU's plane-mask trick existed because the TPU's vector unit was the
bottleneck; here one thread per grid point takes ix, iy, iz straight from
a 3-D launch grid (no integer division) and reads its neighbours through
L1/L2. Terms are summed in offset order without fused multiply-add, so
the kernel matches :func:`stencil_spmv_plain` to the last bit.

The multivector apply (x of shape (n_pad, k), row-major, the JAX
package's public layout) is the same file's ``stencil_mv_kernel``; it
replaces ``stencil_spmm_packed`` (``_plane_kernel_mv``). Bound by bytes,
2·n·k·itemsize over 3.35 TB/s (≈ 0.641 ms for 256³, k = 16, f32). One
thread per (row, column), column fastest, so each row's k values are one
contiguous load; the JAX wrapper's transposes to (k, R, 128) were TPU
layout work and the port has none.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from . import _build
from .dispatch import use_kernel
from .formats import round_up

MAX_TERMS = 32  # csrc/stencil_spmv.cu TT_MAX_TERMS
MAX_GRID_YZ = 65535  # CUDA limit on gridDim.y / gridDim.z


@dataclasses.dataclass(frozen=True)
class StencilOp:
    """Matrix-free stencil operator on a lexicographic grid.

    dims: (nx, ny, nz) — gid = ix + nx*(iy + ny*iz) (Galeri convention)
    offsets: per-term grid offsets (dx, dy, dz)
    coeffs: per-term constant coefficients
    """

    dims: tuple[int, ...]
    offsets: tuple[tuple[int, ...], ...]
    coeffs: tuple[float, ...]
    n_rows_pad: int
    dtype: str = "float32"

    @classmethod
    def create(cls, dims, stencil, n_rows_pad=None, dtype="float32",
               pad_align=1024):
        dims3 = tuple(int(d) for d in dims) + (1,) * (3 - len(dims))
        offs, coeffs = [], []
        for off, c in stencil:
            offs.append(tuple(int(o) for o in off) + (0,) * (3 - len(off)))
            coeffs.append(float(c))
        n = int(np.prod(dims3))
        if n_rows_pad is None:
            n_rows_pad = round_up(n, pad_align)
        return cls(dims=dims3, offsets=tuple(offs), coeffs=tuple(coeffs),
                   n_rows_pad=n_rows_pad, dtype=dtype)

    @property
    def n_rows(self) -> int:
        return int(np.prod(self.dims))

    n_cols = n_rows

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        from .matvec import spmv

        return spmv(self, x)

    @property
    def shape(self):
        return (self.n_rows, self.n_rows)

    @property
    def nnz(self) -> int:
        nx, ny, nz = self.dims
        return sum((nx - abs(dx)) * (ny - abs(dy)) * (nz - abs(dz))
                   for (dx, dy, dz) in self.offsets)

    def lin_offset(self, off3) -> int:
        nx, ny, _ = self.dims
        dx, dy, dz = off3
        return dx + nx * (dy + ny * dz)

    def transposed(self) -> "StencilOp":
        """Aᵀ of a constant stencil: the same coefficients at negated
        offsets."""
        return dataclasses.replace(
            self, offsets=tuple(tuple(-d for d in o) for o in self.offsets))


def stencil_spmv_plain(op: StencilOp, x: torch.Tensor,
                       z_bounds=None) -> torch.Tensor:
    """Plain PyTorch y = A·x for x of shape (n_pad,) or (n_pad, k): one
    roll and mask per term, summed in offset order; pad rows give y = x.

    ``z_bounds`` = (z_lo, z_hi) narrows the valid planes of every term's
    neighbour to z_lo ≤ iz + dz < z_hi (default (0, nz)); the stencil
    polynomial takes it (``stencil_poly.py``)."""
    was_1d = x.ndim == 1
    x2 = x[:, None] if was_1d else x
    n, npad = op.n_rows, op.n_rows_pad
    if x2.shape[0] != npad:
        raise ValueError(f"stencil spmv: x length {x2.shape[0]} != padded "
                         f"rows {npad}")
    nx, ny, nz = op.dims
    z_lo, z_hi = (0, nz) if z_bounds is None else z_bounds
    gid = torch.arange(npad, device=x.device)
    ix = gid % nx
    iy = (gid // nx) % ny
    iz = gid // (nx * ny)
    y = torch.zeros_like(x2)
    for off3, c in zip(op.offsets, op.coeffs):
        o = op.lin_offset(off3)
        dx, dy, dz = off3
        valid = gid < n
        valid &= (ix + dx >= 0) & (ix + dx < nx)
        valid &= (iy + dy >= 0) & (iy + dy < ny)
        valid &= (iz + dz >= z_lo) & (iz + dz < z_hi)
        shifted = torch.roll(x2, -o, dims=0) if o else x2
        y = y + torch.where(valid[:, None], c * shifted, 0)
    y = torch.where((gid >= n)[:, None], x2, y)
    return y[:, 0] if was_1d else y


_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = [_P, _P, ctypes.c_longlong, ctypes.c_longlong, _I, _I, _I, _I, _P, _P,
        _P, _P, _P, _P]
_SIG_MV = _SIG[:7] + [_I] + _SIG[7:]
_TYPES = {torch.float32: "f32", torch.float64: "f64"}
MAX_COLS = 1024  # csrc/stencil_spmv.cu TT_MAX_COLS


@functools.lru_cache(maxsize=64)
def _terms(op: StencilOp):
    """Host arrays of the terms, in the layout the C launcher reads."""
    off = np.asarray(op.offsets, dtype=np.int32).reshape(-1, 3)
    return (np.ascontiguousarray(off[:, 0]), np.ascontiguousarray(off[:, 1]),
            np.ascontiguousarray(off[:, 2]),
            np.asarray([op.lin_offset(o) for o in op.offsets], np.int64),
            np.asarray(op.coeffs, dtype=np.float64))


def _launch(kind: str, op: StencilOp, x: torch.Tensor, *cols) -> torch.Tensor:
    """Checks shared by both kernels, then one launch of
    ``stencil_<kind>_<type>``; ``cols`` is () or (k,)."""
    if x.dtype not in _TYPES:
        raise TypeError(f"stencil kernel takes float32/float64, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("stencil kernel takes a contiguous x")
    nx, ny, nz = op.dims
    if len(op.offsets) > MAX_TERMS or ny > MAX_GRID_YZ or nz > MAX_GRID_YZ:
        raise ValueError(f"stencil kernel takes ≤ {MAX_TERMS} terms and "
                         f"ny, nz ≤ {MAX_GRID_YZ}")
    lib = _build.load("stencil_spmv", {
        f"stencil_{kd}_{t}": sig for kd, sig in (("spmv", _SIG),
                                                  ("spmm", _SIG_MV))
        for t in _TYPES.values()})
    dx, dy, dz, lin, c = _terms(op)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, f"stencil_{kind}_{_TYPES[x.dtype]}")(
            x.data_ptr(), y.data_ptr(), op.n_rows, op.n_rows_pad, nx, ny, nz,
            *cols, len(op.offsets), dx.ctypes.data, dy.ctypes.data,
            dz.ctypes.data, lin.ctypes.data, c.ctypes.data, stream)
    _build.check(lib, rc, f"stencil_{kind}")
    return y


def stencil_spmv(op: StencilOp, x: torch.Tensor) -> torch.Tensor:
    """y = A·x for x of shape (n_pad,) or (n_pad, k): the CUDA kernel for a
    CUDA tensor, the plain version for a CPU tensor. A 2-D x goes to
    :func:`stencil_spmm`. ``stencil_spmv.launches`` counts launches of the
    single-vector kernel."""
    if x.ndim == 2:
        return stencil_spmm(op, x)
    if not use_kernel(x):
        return stencil_spmv_plain(op, x)
    if x.ndim != 1 or x.shape[0] != op.n_rows_pad:
        raise ValueError(f"stencil kernel takes x of shape "
                         f"({op.n_rows_pad},) or ({op.n_rows_pad}, k), got "
                         f"{tuple(x.shape)}")
    y = _launch("spmv", op, x)
    stencil_spmv.launches += 1
    return y


def stencil_spmm(op: StencilOp, x: torch.Tensor) -> torch.Tensor:
    """Y = A·X for X of shape (n_pad, k), k ≥ 1, row-major: the CUDA kernel
    for a CUDA tensor, the plain version for a CPU tensor.
    ``stencil_spmm.launches`` counts kernel launches."""
    if not use_kernel(x):
        return stencil_spmv_plain(op, x)
    if x.ndim != 2 or x.shape[0] != op.n_rows_pad or not (
            1 <= x.shape[1] <= MAX_COLS):
        raise ValueError(f"stencil SpMM kernel takes X of shape "
                         f"({op.n_rows_pad}, k), 1 ≤ k ≤ {MAX_COLS}, got "
                         f"{tuple(x.shape)}")
    y = _launch("spmm", op, x, x.shape[1])
    stencil_spmm.launches += 1
    return y


stencil_spmv.launches = 0
stencil_spmm.launches = 0
