"""One fused CG iteration on a matrix-free stencil.

Counterpart of ``trilinos_tpu/ops/pallas/cg_fused.py``: the single-reduce
(Chronopoulos–Gear) CG recurrence with the identity preconditioner, where
one call updates the directions, x and r, applies the stencil and forms
both dots. State: (x, r, w = A r, p, q = A p) and scal (1, 4) =
[rz, δ, rz_prev, α_prev]. Per call

    β = rz / rz_prev (0 when rz_prev ≤ 0),  α = rz / (δ − β·rz / α_prev),
    p' = r + β p,  q' = w + β q,  x' = x + α p',  r' = r − α q',
    w' = A r',  scal' = [r'·r', r'·w', rz, α].

The operator must have no pad rows (whole grid planes only).

Kernel: ``csrc/cg_fused.cu`` replaces the TPU kernel ``cg_fused_iteration``
(``_kernel``): one launch per iteration, bound by bytes (10·n·itemsize:
five vectors in, five out; ≈ 0.200 ms for 256³ f32 at 3.35 TB/s). One
thread per point would recompute r' from r, w and q at each of its six
neighbours, the ±nx and ±nx·ny ones from L2 (about 12 L2 loads a point
beyond the 10 vectors). The TPU kernel forms r' once over a halo window
in VMEM; the port does the same in shared memory with a z-marching plane
tile: a block owns a 32 × 8 tile and a z-chunk, each plane of r, w, q
enters a shared-memory ring once with its halo (asynchronous copies, two
planes ahead), and the stencil forms r' at each neighbour from the ring.
:func:`cg_fused_plan` chooses the geometry on the host (z-chunks for
about 4096 blocks, the ring's bytes) and the launcher checks it. Every r'
is formed by the expression of the stored r', with round-to-nearest
operations, and halo points outside the grid hold +0, which adds nothing
to a sum, so the vectors equal the plain version's bit for bit given the
same scal; the dots are summed per thread and block in double, so scal'
agrees with the plain version's ``torch.sum`` to a tolerance.
``cg_fused_iteration.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from . import _build
from .dispatch import use_kernel
from .stencil_op import (MAX_GRID_YZ, MAX_TERMS, StencilOp, _terms,
                         stencil_spmv_plain)

# csrc/cg_fused.cu TT_TILE_X, TT_TILE_Y, TT_DEPTH: a block is one thread per
# point of a TILE_X × TILE_Y tile; its ring holds 2·rz + 1 planes read and
# DEPTH planes in flight
TILE_X, TILE_Y = 32, 8
DEPTH = 2
TARGET_BLOCKS = 4096  # z-chunks are cut so a launch has about this many
MIN_ZC = 8  # shorter chunks would load mostly halo planes
MAX_SMEM = 232448  # bytes of shared memory one block may take

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = [_P] * 13 + [ctypes.c_longlong, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                    _P, _P]
_TYPES = {torch.float32: "f32", torch.float64: "f64"}


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """Launch geometry of the kernel (``csrc/cg_fused.cu`` ``TilePlan``,
    fields in the same order). Block (bx, by, bz) owns the TILE_X × TILE_Y
    tile at (bx·TILE_X, by·TILE_Y) and the output planes
    [bz·zc, (bz+1)·zc), one thread per point; its ring of
    ``2·rz + 1 + DEPTH`` slots in ``smem`` bytes of shared memory holds the
    r, w, q plane tiles with their (rx, ry) halo and x, p at the tile's
    points."""

    zc: int
    rx: int
    ry: int
    rz: int
    smem: int
    grid: tuple[int, int, int]

    @property
    def block(self) -> tuple[int, int, int]:
        return (TILE_X, TILE_Y, 1)

    @property
    def threads(self) -> int:
        return TILE_X * TILE_Y

    @property
    def n_blocks(self) -> int:
        return math.prod(self.grid)

    @functools.cached_property
    def fields(self) -> np.ndarray:
        """The int32 array the C launcher reads."""
        return np.asarray([self.zc, self.rx, self.ry, self.rz, self.smem,
                           *self.grid], dtype=np.int32)


def stencil_radii(op: StencilOp) -> tuple[int, int, int]:
    """The largest |offset| of the operator along x, y and z."""
    off = np.abs(np.asarray(op.offsets, dtype=np.int64).reshape(-1, 3))
    return tuple(int(r) for r in off.max(axis=0)) if len(off) else (0, 0, 0)


@functools.lru_cache(maxsize=64)
def cg_fused_plan(op: StencilOp, itemsize: int) -> TilePlan:
    """The kernel's geometry for elements of ``itemsize`` bytes: TILE_X ×
    TILE_Y tiles, z-chunks of at least MIN_ZC planes for about
    TARGET_BLOCKS blocks, and shared memory for the ring. Raises ValueError
    where it breaks a launch limit. Cached: the solver asks once per
    iteration."""
    nx, ny, nz = op.dims
    rx, ry, rz = stencil_radii(op)
    tiles_x, tiles_y = -(-nx // TILE_X), -(-ny // TILE_Y)
    zc = min(nz, max(MIN_ZC, -(-tiles_x * tiles_y * nz // TARGET_BLOCKS)))
    slots = 2 * rz + 1 + DEPTH
    smem = slots * (3 * (TILE_X + 2 * rx) * (TILE_Y + 2 * ry)
                    + 2 * TILE_X * TILE_Y) * itemsize
    plan = TilePlan(zc=zc, rx=rx, ry=ry, rz=rz, smem=smem,
                    grid=(tiles_x, tiles_y, -(-nz // zc)))
    if smem > MAX_SMEM or max(plan.grid[1:]) > MAX_GRID_YZ:
        raise ValueError(
            f"cg_fused: no launch fits ({smem} bytes of shared memory ≤ "
            f"{MAX_SMEM}, grid {plan.grid} within gridDim.y, gridDim.z ≤ "
            f"{MAX_GRID_YZ})")
    return plan


def cg_fused_applicable(op) -> bool:
    """A StencilOp with no pad rows, ≤ MAX_TERMS terms and a plan that fits
    the launch limits in f64 (f32 takes half its shared memory)."""
    if not (isinstance(op, StencilOp) and op.n_rows_pad == op.n_rows
            and len(op.offsets) <= MAX_TERMS):
        return False
    try:
        cg_fused_plan(op, 8)
    except ValueError:
        return False
    return True


def require_applicable(op) -> None:
    """Raise ValueError unless :func:`cg_fused_applicable`."""
    if not cg_fused_applicable(op):
        raise ValueError(
            f"cg_fused needs a StencilOp without pad rows (got "
            f"{type(op).__name__}, n_rows {getattr(op, 'n_rows', '?')}, "
            f"n_rows_pad {getattr(op, 'n_rows_pad', '?')}), ≤ {MAX_TERMS} "
            f"terms and a grid the launch covers")


def cg_fused_iteration_plain(op: StencilOp, x, r_vec, w_vec, p_vec, q_vec,
                             scal):
    """Plain PyTorch iteration: the kernel's arithmetic, dots by
    ``torch.sum``."""
    rz, delta, rz_prev, alpha_prev = scal[0]
    beta = torch.where(rz_prev > 0, rz / torch.where(rz_prev > 0, rz_prev, 1),
                       0)
    denom = delta - beta * rz / torch.where(alpha_prev != 0, alpha_prev, 1)
    alpha = torch.where(denom != 0, rz / torch.where(denom != 0, denom, 1), 0)
    p_new = r_vec + beta * p_vec
    q_new = w_vec + beta * q_vec
    x_new = x + alpha * p_new
    r_new = r_vec - alpha * q_new
    w_new = stencil_spmv_plain(op, r_new)
    scal_new = torch.stack([torch.sum(r_new * r_new),
                            torch.sum(r_new * w_new), rz, alpha])
    return x_new, r_new, w_new, p_new, q_new, scal_new.reshape(1, 4)


def _call(op: StencilOp, vecs, scal, outs, scal_out, work,
          plan: TilePlan) -> None:
    """One launch of ``cg_fused_<type>`` on the vectors' stream."""
    x = vecs[0]
    lib = _build.load("cg_fused", {f"cg_fused_{t}": _SIG
                                   for t in _TYPES.values()})
    dx, dy, dz, lin, c = _terms(op)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, f"cg_fused_{_TYPES[x.dtype]}")(
            *(v.data_ptr() for v in vecs), scal.data_ptr(),
            *(o.data_ptr() for o in outs), scal_out.data_ptr(),
            work.data_ptr(), work.numel(), *op.dims, len(op.offsets),
            dx.ctypes.data, dy.ctypes.data, dz.ctypes.data, lin.ctypes.data,
            c.ctypes.data, plan.fields.ctypes.data, stream)
    _build.check(lib, rc, "cg_fused")


def _launch(op: StencilOp, vecs, scal):
    x = vecs[0]
    if x.dtype not in _TYPES:
        raise TypeError(f"cg_fused kernel takes float32/float64, got "
                        f"{x.dtype}")
    if not all(v.is_contiguous() for v in (*vecs, scal)):
        raise ValueError("cg_fused kernel takes contiguous tensors")
    plan = cg_fused_plan(op, x.element_size())
    outs = [torch.empty_like(v) for v in vecs]
    scal_out = torch.empty_like(scal)
    # a partial (r'·r', r'·w') per block, then the last block's ticket
    work = torch.empty(2 * plan.n_blocks + 1, dtype=torch.float64,
                       device=x.device)
    _call(op, vecs, scal, outs, scal_out, work, plan)
    return (*outs, scal_out)


def cg_fused_iteration(op: StencilOp, x, r_vec, w_vec, p_vec, q_vec, scal):
    """One fused CG iteration: returns (x', r', w', p', q', scal'). The CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    require_applicable(op)
    vecs = (x, r_vec, w_vec, p_vec, q_vec)
    if any(v.shape != (op.n_rows,) or v.dtype != x.dtype
           or v.device != x.device for v in vecs):
        raise ValueError(f"cg_fused takes five vectors of shape "
                         f"({op.n_rows},), one dtype and device")
    if scal.shape != (1, 4) or scal.dtype != x.dtype \
            or scal.device != x.device:
        raise ValueError("cg_fused takes scal of shape (1, 4) in the "
                         "vectors' dtype and device")
    if not use_kernel(x):
        return cg_fused_iteration_plain(op, *vecs, scal)
    out = _launch(op, vecs, scal)
    cg_fused_iteration.launches += 1
    return out


cg_fused_iteration.launches = 0
