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
bottleneck; here a thread owns vw consecutive points along x (16 bytes
where nx and the pointers allow it), takes its x±1 terms from its warp
neighbours by shuffle and, for Galeri's 7-point cross, marches a z-chunk
keeping planes z − 1, z, z + 1 in registers (out-of-range terms add a
selected +0). Other stencils take a generic instance, one point a thread
and one plane a block. :func:`spmv_plan` picks the instance and the
launch on the host; the launcher checks it (``csrc/spmv_plan.cuh``).
Terms are summed in offset order without fused multiply-add, so the
kernel matches :func:`stencil_spmv_plain` to the last bit.

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
MAX_BLOCK_Z = 64  # CUDA's limit on blockDim.z (x and y take 1024)


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
# (x, y, n, n_pad, nx, ny, nz, n_terms, dx, dy, dz, lin, coeff, plan, stream)
_SIG = [_P, _P, ctypes.c_longlong, ctypes.c_longlong, _I, _I, _I, _I, _P, _P,
        _P, _P, _P, _P, _P]
_SIG_MV = _SIG[:7] + [_I] + _SIG[7:]  # k after nz
_TYPES = {torch.float32: "f32", torch.float64: "f64"}
MAX_COLS = 1024  # csrc/stencil_spmv.cu TT_MAX_COLS
VEC_BYTES = 16  # the widest load or store of one thread
MV_THREADS = 256  # about this many threads in a SpMM block
SPMV_THREADS = 256  # csrc/spmv_plan.cuh TT_SPMV_THREADS
SPMV_ROW = 64  # csrc/spmv_plan.cuh TT_SPMV_ROW: threads along x, at most
SPMV_ZC = 32  # csrc/spmv_plan.cuh TT_SPMV_ZC: planes a block marches, at most
SPMV_MIN_BLOCKS = 4096  # the z-chunk halves until the launch has this many
# Galeri's 7-point cross in its own term order (galeri/stencils.py
# cross3d_stencil): the kernel's compile-time instance
CROSS_OFFSETS = ((0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0),
                 (0, 0, -1), (0, 0, 1))


@dataclasses.dataclass(frozen=True)
class SpmvPlan:
    """Launch of the single-vector kernel: ``vw`` points along x a thread;
    ``cross`` for the 7-point cross's z-marching instance, else the
    generic instance (one point a thread); a block of (bx, by, 1) threads
    over bx·vw × by points of a plane; each block marches ``zc`` planes."""

    vw: int
    cross: bool
    block: tuple[int, int, int]
    grid: tuple[int, int, int]
    zc: int

    def fields(self) -> np.ndarray:
        """The int32 array the C launcher reads."""
        return np.asarray([self.vw, self.cross, *self.block, *self.grid,
                           self.zc], dtype=np.int32)


@functools.lru_cache(maxsize=64)
def spmv_plan(op: StencilOp, itemsize: int,
              align: int = VEC_BYTES) -> SpmvPlan:
    """The single-vector kernel's launch for elements of ``itemsize``
    bytes whose pointers (x's and y's) are multiples of ``align`` bytes.
    Galeri's 7-point cross: vw is the widest of 16, 8, 4 bytes (then one
    element) that divides nx and the alignment, and a block marches a
    z-chunk of SPMV_ZC planes, halved until the launch has SPMV_MIN_BLOCKS
    blocks (or one plane a block). Any other stencil: one point a thread,
    one plane a block. A block takes at most SPMV_THREADS threads,
    SPMV_ROW along x; the grid is the one that covers the points. Raises
    ValueError where the launch breaks a limit."""
    nx, ny, nz = op.dims
    n_terms = len(op.offsets)
    if n_terms > MAX_TERMS:
        raise ValueError(f"stencil kernel takes ≤ {MAX_TERMS} terms")
    cross = tuple(op.offsets) == CROSS_OFFSETS
    vw, zc = 1, 1
    if cross:
        vw, zc = VEC_BYTES // itemsize, SPMV_ZC
        while vw > 1 and (nx % vw or align % (vw * itemsize)):
            vw //= 2
    bx = min(nx // vw, SPMV_ROW)
    by = min(ny, SPMV_THREADS // bx)
    gx, gy = -(-nx // (bx * vw)), -(-ny // by)
    while zc > 1 and gx * gy * -(-nz // zc) < SPMV_MIN_BLOCKS:
        zc //= 2
    grid = (gx, gy, -(-nz // zc))
    if max(grid[1:]) > MAX_GRID_YZ:
        raise ValueError(f"stencil kernel: grid {grid} passes gridDim.y, "
                         f"gridDim.z ≤ {MAX_GRID_YZ}")
    return SpmvPlan(vw=vw, cross=cross, block=(bx, by, 1), grid=grid, zc=zc)


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
    MV_THREADS threads, at most MAX_BLOCK_Z of them along z (a grid of
    few, long rows gets fewer threads rather than an illegal block).
    Raises ValueError where the launch breaks a limit."""
    if not 1 <= k <= MAX_COLS:
        raise ValueError(f"stencil SpMM takes 1 ≤ k ≤ {MAX_COLS}, got {k}")
    nx, ny, nz = op.dims
    vw = VEC_BYTES // itemsize
    while vw > 1 and (k % vw or align % (vw * itemsize)):
        vw //= 2
    lanes = k // vw
    rx = min(nx, max(1, MV_THREADS // lanes))
    ry = min(ny, MAX_BLOCK_Z, max(1, MV_THREADS // (lanes * rx)))
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
          plan: SpmvPlan | SpmmPlan) -> None:
    """One launch of the C entry ``fn`` on x's stream: (x, y, n, n_pad,
    nx, ny, nz, *extra, the terms, plan, stream)."""
    lib = _library()
    dx, dy, dz, lin, c = _terms(op)
    fields = plan.fields()  # alive for the call
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, fn)(
            x.data_ptr(), y.data_ptr(), op.n_rows, op.n_rows_pad, *op.dims,
            *extra, len(op.offsets), dx.ctypes.data, dy.ctypes.data,
            dz.ctypes.data, lin.ctypes.data, c.ctypes.data,
            fields.ctypes.data, stream)
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
    plan = spmv_plan(op, x.element_size(), pointer_align(x, y))
    _call(f"stencil_spmv_{_TYPES[x.dtype]}", op, x, y, plan=plan)
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
