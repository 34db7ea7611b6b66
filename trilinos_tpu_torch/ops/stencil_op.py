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

The multivector apply (X of shape (n_pad, k), row-major, the JAX
package's public layout) is the same file's ``stencil_mv_kernel``; it
replaces ``stencil_spmm_packed`` (``_plane_kernel_mv``). Bound by bytes,
2·n·k·itemsize over 3.35 TB/s (≈ 0.641 ms for 256³, k = 16, f32). One
thread per (row, vw columns), columns fastest, so each row's k values are
contiguous loads; a thread moves its vw columns as one 16-byte load per
term and one store (4 × f32, 2 × f64), narrower where k or the pointers
do not allow it. :func:`spmm_plan` picks vw and the launch on the host;
the launcher checks it. Terms are summed in offset order without fused
multiply-add, so the result is bitwise the plain version's. The JAX
wrapper's transposes to (k, R, 128) were TPU layout work and the port has
none.
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

MAX_TERMS = 32  # csrc/tt_common.cuh TT_MAX_TERMS
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
_SIG_MV = _SIG[:7] + [_I] + _SIG[7:13] + [_P, _P]  # k, then the plan
_TYPES = {torch.float32: "f32", torch.float64: "f64"}
MAX_COLS = 1024  # csrc/stencil_spmv.cu TT_MAX_COLS
VEC_BYTES = 16  # the widest load or store of one thread
MV_THREADS = 256  # about this many threads in a SpMM block


@dataclasses.dataclass(frozen=True)
class SpmmPlan:
    """Launch of the SpMM kernel: ``vw`` columns a thread, a block of
    (k / vw, rx, ry) threads over rx × ry points of one plane, one plane
    per grid z."""

    vw: int
    block: tuple[int, int, int]
    grid: tuple[int, int, int]

    def fields(self) -> np.ndarray:
        """The int32 array the C launcher reads."""
        return np.asarray([self.vw, *self.block, *self.grid], dtype=np.int32)


def spmm_plan(op: StencilOp, k: int, itemsize: int,
              align: int = VEC_BYTES) -> SpmmPlan:
    """The SpMM kernel's launch for X of shape (n_pad, k) with elements of
    ``itemsize`` bytes whose pointers (X's and Y's) are multiples of
    ``align`` bytes: vw is the widest of 16, 8, 4 bytes (then one element)
    that divides the row and the alignment, and a block takes about
    MV_THREADS threads. Raises ValueError where the launch breaks a
    limit."""
    if not 1 <= k <= MAX_COLS:
        raise ValueError(f"stencil SpMM takes 1 ≤ k ≤ {MAX_COLS}, got {k}")
    nx, ny, nz = op.dims
    vw = VEC_BYTES // itemsize
    while vw > 1 and (k % vw or align % (vw * itemsize)):
        vw //= 2
    lanes = k // vw
    rx = min(nx, max(1, MV_THREADS // lanes))
    ry = min(ny, max(1, MV_THREADS // (lanes * rx)))
    grid = (-(-nx // rx), -(-ny // ry), nz)
    if max(grid[1:]) > MAX_GRID_YZ:
        raise ValueError(f"stencil SpMM: grid {grid} passes gridDim.y, "
                         f"gridDim.z ≤ {MAX_GRID_YZ}")
    return SpmmPlan(vw=vw, block=(lanes, rx, ry), grid=grid)


def pointer_align(*tensors) -> int:
    """The largest power of two up to VEC_BYTES dividing every data
    pointer."""
    bits = VEC_BYTES
    for t in tensors:
        bits |= t.data_ptr()
    return bits & -bits


@functools.lru_cache(maxsize=64)
def _terms(op: StencilOp):
    """Host arrays of the terms, in the layout the C launcher reads."""
    off = np.asarray(op.offsets, dtype=np.int32).reshape(-1, 3)
    return (np.ascontiguousarray(off[:, 0]), np.ascontiguousarray(off[:, 1]),
            np.ascontiguousarray(off[:, 2]),
            np.asarray([op.lin_offset(o) for o in op.offsets], np.int64),
            np.asarray(op.coeffs, dtype=np.float64))


def _library():
    return _build.load("stencil_spmv", {
        f"stencil_{kd}_{t}": sig for kd, sig in (("spmv", _SIG),
                                                  ("spmm", _SIG_MV))
        for t in _TYPES.values()})


def _call(fn: str, op: StencilOp, x: torch.Tensor, y: torch.Tensor, *extra,
          plan: SpmmPlan | None = None) -> None:
    """One launch of the C entry ``fn`` on x's stream: (x, y, n, n_pad,
    nx, ny, nz, *extra, the terms[, plan], stream)."""
    lib = _library()
    dx, dy, dz, lin, c = _terms(op)
    fields = None if plan is None else plan.fields()  # alive for the call
    plan_args = () if fields is None else (fields.ctypes.data,)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, fn)(
            x.data_ptr(), y.data_ptr(), op.n_rows, op.n_rows_pad, *op.dims,
            *extra, len(op.offsets), dx.ctypes.data, dy.ctypes.data,
            dz.ctypes.data, lin.ctypes.data, c.ctypes.data, *plan_args,
            stream)
    _build.check(lib, rc, fn)


def _check_input(op: StencilOp, x: torch.Tensor) -> None:
    if x.dtype not in _TYPES:
        raise TypeError(f"stencil kernel takes float32/float64, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("stencil kernel takes a contiguous x")
    if len(op.offsets) > MAX_TERMS:
        raise ValueError(f"stencil kernel takes ≤ {MAX_TERMS} terms")


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
    _check_input(op, x)
    if op.dims[1] > MAX_GRID_YZ or op.dims[2] > MAX_GRID_YZ:
        raise ValueError(f"stencil kernel takes ny, nz ≤ {MAX_GRID_YZ}")
    y = torch.empty_like(x)
    _call(f"stencil_spmv_{_TYPES[x.dtype]}", op, x, y)
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
    _check_input(op, x)
    k = x.shape[1]
    y = torch.empty_like(x)
    plan = spmm_plan(op, k, x.element_size(), pointer_align(x, y))
    _call(f"stencil_spmm_{_TYPES[x.dtype]}", op, x, y, k, plan=plan)
    stencil_spmm.launches += 1
    return y


stencil_spmv.launches = 0
stencil_spmm.launches = 0
