"""Block-DIA apply: plain PyTorch versions and the CUDA kernel wrappers.

Counterpart of the XLA BDIA applies in ``trilinos_tpu/ops/matvec.py``
(``bdia_spmm``, ``bdia_spmm_t``) and of the TPU kernel in
``trilinos_tpu/ops/pallas/bdia_spmv.py`` (``bdia_spmm_packed`` with its
wrappers and ``bdia_plane_solver_op``).

x comes in one of two layouts. Interleaved: (n_pad,) or (n_pad, k), row
q·b + j holding component j of block row q. Planes: (b·k, nbr_pad), plane
p = j·k + m holding component j of column m. Both are views of one
(q, j, m) index space, and the apply is

    y[q, i, m] = Σ_d Σ_j data[d, i, j, q] · x[q + off_d, j, m].

Kernel: ``csrc/bdia_spmv.cu`` serves both layouts by strides, for b ≤ 8
and up to 512 block offsets, so the coarse elasticity levels (b = 6, 125
and 343 offsets) run on it too. On an H100 it is bound by bytes,
(nd·b²·itemsize(data) + 2·b·k·itemsize(x))·nbr_pad over 3.35 TB/s. The
transpose stays plain PyTorch on every device, as the JAX package leaves
it to XLA.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build
from .dispatch import use_kernel
from .formats import BdiaMatrix

MAX_B = 8  # csrc/bdia_spmv.cu TT_BDIA_MAX_B
MAX_OFFSETS = 512  # csrc/bdia_spmv.cu TT_BDIA_MAX_OFFSETS

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIG = [_P, _P, _P, _L, _I, _I, _L, _L, _L, _I, _P, _P]
_TYPES = {(torch.float32, torch.float32): "f32",
          (torch.float64, torch.float64): "f64",
          (torch.bfloat16, torch.float32): "bf16f32"}


def _interleaved(a: BdiaMatrix, x: torch.Tensor) -> torch.Tensor:
    """The (q, j, m) view of an interleaved (n_pad,) or (n_pad, k) x."""
    if x.ndim not in (1, 2) or x.shape[0] != a.n_rows_pad:
        raise ValueError(f"BDIA spmv: x of shape {tuple(x.shape)}, expected "
                         f"({a.n_rows_pad},) or ({a.n_rows_pad}, k)")
    x2 = x[:, None] if x.ndim == 1 else x
    return x2.reshape(a.nbr_pad, a.block_size, x2.shape[1])


def _planes(a: BdiaMatrix, xp: torch.Tensor) -> torch.Tensor:
    """The (q, j, m) view of packed planes (b·k, nbr_pad)."""
    b = a.block_size
    if xp.ndim != 2 or xp.shape[1] != a.nbr_pad or xp.shape[0] % b:
        raise ValueError(f"BDIA planes of shape {tuple(xp.shape)}, expected "
                         f"({b}·k, {a.nbr_pad})")
    return xp.reshape(b, xp.shape[0] // b, a.nbr_pad).permute(2, 0, 1)


def _apply_plain(a: BdiaMatrix, x3: torch.Tensor) -> torch.Tensor:
    """(nbr, b, k) → (nbr, b, k): per offset one shift and one (i, j)
    contraction as an elementwise product summed over j."""
    y = torch.zeros(x3.shape, dtype=torch.promote_types(a.dtype, x3.dtype),
                    device=x3.device)
    for d, off in enumerate(a.offsets):
        shifted = torch.roll(x3, -off, dims=0) if off else x3
        blocks = a.data[d].permute(2, 0, 1)[..., None]  # (q, i, j, 1)
        y = y + (blocks * shifted[:, None]).sum(2)
    return y


def bdia_spmv_plain(a: BdiaMatrix, x: torch.Tensor) -> torch.Tensor:
    """Plain y = A·x for an interleaved (n_pad,) or (n_pad, k) x, by rolls
    (exact, because out-of-range plane positions store zeros)."""
    return _apply_plain(a, _interleaved(a, x)).reshape(x.shape)


def bdia_spmv_t_plain(a: BdiaMatrix, x: torch.Tensor) -> torch.Tensor:
    """Transpose apply: yᵀ[q + off_d, j, m] += Σ_i data[d, i, j, q] ·
    x[q, i, m]."""
    x3 = _interleaved(a, x)
    y = torch.zeros(x3.shape, dtype=torch.promote_types(a.dtype, x.dtype),
                    device=x.device)
    for d, off in enumerate(a.offsets):
        blocks = a.data[d].permute(2, 0, 1)[..., None]  # (q, i, j, 1)
        term = (blocks * x3[:, :, None]).sum(1)
        y = y + (torch.roll(term, off, dims=0) if off else term)
    return y.reshape(x.shape)


def bdia_planes_plain(a: BdiaMatrix, xp: torch.Tensor) -> torch.Tensor:
    """Plain y = A·x on packed planes (b·k, nbr_pad)."""
    y3 = _apply_plain(a, _planes(a, xp))
    return y3.permute(1, 2, 0).reshape(xp.shape)


def pack_planes(a: BdiaMatrix, x: torch.Tensor) -> torch.Tensor:
    """Interleaved (n_pad,) or (n_pad, k) → packed planes (b·k, nbr_pad),
    plane p = j·k + m (a contiguous copy)."""
    x3 = _interleaved(a, x)
    return x3.permute(1, 2, 0).contiguous().reshape(-1, a.nbr_pad)


def unpack_planes(a: BdiaMatrix, xp: torch.Tensor) -> torch.Tensor:
    """Packed planes (b·k, nbr_pad) → interleaved (n_pad, k)."""
    x3 = _planes(a, xp)
    return x3.reshape(a.n_rows_pad, x3.shape[2])


@functools.lru_cache(maxsize=64)
def _offsets(offsets: tuple[int, ...]) -> np.ndarray:
    return np.asarray(offsets, dtype=np.int32)


def _launch(a: BdiaMatrix, x: torch.Tensor, x3: torch.Tensor) -> torch.Tensor:
    """One launch of ``bdia_spmm_<types>`` on the (q, j, m) view ``x3`` of
    the contiguous ``x``; y gets x's layout."""
    types = _TYPES.get((a.dtype, x.dtype))
    if types is None:
        raise TypeError(f"BDIA kernel takes f32/f32, f64/f64 or bf16/f32 "
                        f"data/x, got {a.dtype}/{x.dtype}")
    if not (x.is_contiguous() and a.data.is_contiguous()):
        raise ValueError("BDIA kernel takes contiguous data and x")
    if a.data.device != x.device:
        raise ValueError(f"BDIA data on {a.data.device}, x on {x.device}")
    if a.block_size > MAX_B or len(a.offsets) > MAX_OFFSETS:
        raise ValueError(f"BDIA kernel takes b ≤ {MAX_B} and ≤ {MAX_OFFSETS} "
                         f"offsets, got b = {a.block_size}, "
                         f"{len(a.offsets)} offsets")
    lib = _build.load("bdia_spmv", {f"bdia_spmm_{t}": _SIG
                                    for t in _TYPES.values()})
    offs = _offsets(a.offsets)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, f"bdia_spmm_{types}")(
            a.data.data_ptr(), x.data_ptr(), y.data_ptr(), a.nbr_pad,
            a.block_size, x3.shape[2], *x3.stride(), len(a.offsets),
            offs.ctypes.data, stream)
    _build.check(lib, rc, "bdia_spmm")
    return y


def bdia_spmv(a: BdiaMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A·x for an interleaved x of shape (n_pad,) or (n_pad, k): the
    CUDA kernel for a CUDA tensor, the plain version for a CPU tensor. A
    2-D x goes to :func:`bdia_spmm`. ``bdia_spmv.launches`` counts the
    kernel launches of single vectors."""
    if x.ndim == 2:
        return bdia_spmm(a, x)
    x3 = _interleaved(a, x)
    if not use_kernel(x):
        return bdia_spmv_plain(a, x)
    y = _launch(a, x, x3)
    bdia_spmv.launches += 1
    return y


def bdia_spmm(a: BdiaMatrix, x: torch.Tensor,
              layout: str = "interleaved") -> torch.Tensor:
    """Y = A·X for an interleaved X of shape (n_pad, k) or, with
    ``layout="planes"``, packed planes of shape (b·k, nbr_pad); Y has X's
    layout. The CUDA kernel for a CUDA tensor, the plain version for a CPU
    tensor. ``bdia_spmm.launches`` counts kernel launches."""
    if layout == "planes":
        x3, plain = _planes(a, x), bdia_planes_plain
    elif layout == "interleaved":
        if x.ndim != 2:
            raise ValueError(f"BDIA SpMM takes X of shape ({a.n_rows_pad}, "
                             f"k), got {tuple(x.shape)}")
        x3, plain = _interleaved(a, x), bdia_spmv_plain
    else:
        raise ValueError(f"unknown BDIA layout {layout!r}")
    if not use_kernel(x):
        return plain(a, x)
    y = _launch(a, x, x3)
    bdia_spmm.launches += 1
    return y


bdia_spmv.launches = 0
bdia_spmm.launches = 0


def bdia_plane_solver_op(a: BdiaMatrix, k: int = 1):
    """Solve in plane layout: returns ``(op, pack, unpack)``.

        op, pack, unpack = bdia_plane_solver_op(a)
        res = cg(op, pack(b), ...)
        x = unpack(res.x)

    ``pack`` takes an interleaved (n_pad,) or (n_pad, k) vector to a flat
    plane vector, ``op`` applies A to flat plane vectors (on the card one
    kernel launch in plane layout) and ``unpack`` returns to the
    interleaved layout ((n_pad,) for k = 1). Krylov dots and axpys do not
    depend on the order of the rows, so the whole solve runs on planes."""
    b, nbr = a.block_size, a.nbr_pad

    def op(v: torch.Tensor) -> torch.Tensor:
        if v.shape != (b * k * nbr,):
            raise ValueError(f"BDIA planes: the op takes ({b * k * nbr},), "
                             f"got {tuple(v.shape)}")
        return bdia_spmm(a, v.reshape(b * k, nbr), layout="planes").reshape(-1)

    def pack(x: torch.Tensor) -> torch.Tensor:
        x2 = x[:, None] if x.ndim == 1 else x
        if x2.shape[1] != k:
            raise ValueError(f"pack: {x2.shape[1]} columns, the op takes {k}")
        return pack_planes(a, x2).reshape(-1)

    def unpack(v: torch.Tensor) -> torch.Tensor:
        y = unpack_planes(a, v.reshape(b * k, nbr))
        return y[:, 0] if k == 1 else y

    return op, pack, unpack
