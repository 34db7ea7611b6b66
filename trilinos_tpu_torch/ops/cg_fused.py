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
five vectors in, five out). Its vectors equal the plain version's bit for
bit given the same scal; its dots are summed per block in double, so scal'
agrees with the plain version's ``torch.sum`` to a tolerance.
``cg_fused_iteration.launches`` counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .dispatch import use_kernel
from .stencil_op import (MAX_GRID_YZ, MAX_TERMS, StencilOp, _terms,
                         stencil_spmv_plain)

BLOCK_X, BLOCK_Y = 32, 8  # csrc/cg_fused.cu TT_BX, TT_BY

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = [_P] * 13 + [ctypes.c_longlong, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                    _P]
_TYPES = {torch.float32: "f32", torch.float64: "f64"}


def cg_fused_applicable(op) -> bool:
    """A StencilOp with no pad rows that the kernel's launch grid covers."""
    return (isinstance(op, StencilOp) and op.n_rows_pad == op.n_rows
            and len(op.offsets) <= MAX_TERMS
            and -(-op.dims[1] // BLOCK_Y) <= MAX_GRID_YZ
            and op.dims[2] <= MAX_GRID_YZ)


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


def _launch(op: StencilOp, vecs, scal):
    x = vecs[0]
    if x.dtype not in _TYPES:
        raise TypeError(f"cg_fused kernel takes float32/float64, got "
                        f"{x.dtype}")
    if not all(v.is_contiguous() for v in (*vecs, scal)):
        raise ValueError("cg_fused kernel takes contiguous tensors")
    lib = _build.load("cg_fused", {f"cg_fused_{t}": _SIG
                                   for t in _TYPES.values()})
    nx, ny, nz = op.dims
    nblocks = -(-nx // BLOCK_X) * -(-ny // BLOCK_Y) * nz
    outs = [torch.empty_like(v) for v in vecs]
    scal_out = torch.empty_like(scal)
    work = torch.empty(2 * nblocks + 1, dtype=torch.float64, device=x.device)
    dx, dy, dz, lin, c = _terms(op)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, f"cg_fused_{_TYPES[x.dtype]}")(
            *(v.data_ptr() for v in vecs), scal.data_ptr(),
            *(o.data_ptr() for o in outs), scal_out.data_ptr(),
            work.data_ptr(), work.numel(), nx, ny, nz, len(op.offsets),
            dx.ctypes.data, dy.ctypes.data, dz.ctypes.data, lin.ctypes.data,
            c.ctypes.data, stream)
    _build.check(lib, rc, "cg_fused")
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
