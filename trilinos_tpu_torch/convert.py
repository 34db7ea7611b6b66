"""Carry the JAX package's operators and AMG state into the port.

The functions here take numpy arrays and plain fields — never JAX objects
by type — so both packages can apply the same hierarchy: a caller turns
every array of the JAX package's ``SaAmg.state()`` into numpy (for example
with ``jax.tree_util.tree_map(np.asarray, state)``) and hands it to
:func:`amg_state_from_jax`, or the same of a ``BlockStructuredAmg.state()``
to :func:`block_amg_state_from_jax`. bfloat16 arrays are widened to float32
on the host (exact) and narrowed back on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .ops.formats import (BdiaMatrix, BsrMatrix, CsrHost, DiaMatrix,
                          EllMatrix, dia_from_host)
from .ops.stencil_op import StencilOp
from .precond.amg import structured_block
from .precond.jacobi import Relaxation


def _to_device(arr, device) -> torch.Tensor:
    """A tensor on ``device`` with ``arr``'s values and element type
    (float32, float64 or bfloat16)."""
    arr = np.array(arr)  # a writable copy: torch wraps it without copying
    if arr.dtype.name == "bfloat16":
        # torch reads no numpy bfloat16; the widening to f32 is exact
        return torch.from_numpy(arr.astype(np.float32)).to(
            resolve_device(device), torch.bfloat16)
    return torch.from_numpy(arr).to(resolve_device(device))


def dia_from_numpy(data, offsets, n_rows: int, n_cols: int, nnz: int,
                   device=None) -> DiaMatrix:
    """A DiaMatrix from diagonals stored ``(nd, n_rows_pad)`` or in the JAX
    package's lane-packed ``(nd, n_rows_pad // 128, 128)`` layout. The
    element type is kept: float32, float64 or bfloat16."""
    data = np.array(data)  # a writable copy: torch wraps it without copying
    data = data.reshape(data.shape[0], -1)
    if data.dtype.name == "bfloat16":
        return DiaMatrix(data=_to_device(data, device),
                         offsets=tuple(int(o) for o in offsets),
                         n_rows=n_rows, n_cols=n_cols, nnz=nnz)
    return dia_from_host(data, offsets, n_rows, n_cols, nnz, data.dtype,
                         device)


def bdia_from_numpy(data, offsets, block_size: int, n_rows: int, n_cols: int,
                    nnz: int, device=None) -> BdiaMatrix:
    """A BdiaMatrix from planes stored ``(nd, b, b, nbr_pad)`` or in the JAX
    package's lane-packed ``(nd·b², nbr_pad // 128, 128)`` layout. The
    element type is kept: float32, float64 or bfloat16."""
    data = np.asarray(data)
    b = int(block_size)
    nd = len(offsets)
    if data.size % (nd * b * b):
        raise ValueError(f"BDIA data of shape {data.shape} does not hold "
                         f"{nd} offsets of {b}x{b} blocks")
    t = _to_device(data.reshape(nd, b, b, -1), device)
    return BdiaMatrix(data=t, offsets=tuple(int(o) for o in offsets),
                      block_size=b, n_rows=int(n_rows), n_cols=int(n_cols),
                      nnz=int(nnz))


def ell_from_numpy(cols, vals, n_rows: int, n_cols: int, nnz: int,
                   device=None) -> EllMatrix:
    """An EllMatrix from its (n_rows_pad, k) column and value arrays."""
    return EllMatrix(cols=torch.from_numpy(np.array(cols, np.int64)).to(
        resolve_device(device)), vals=_to_device(vals, device),
        n_rows=int(n_rows), n_cols=int(n_cols), nnz=int(nnz))


def bsr_from_numpy(bcols, bvals, block_size: int, n_rows: int, n_cols: int,
                   nnz: int, device=None) -> BsrMatrix:
    """A BsrMatrix from its (n_brows_pad, kb) block columns and
    (n_brows_pad, kb, b, b) blocks."""
    return BsrMatrix(bcols=torch.from_numpy(np.array(bcols, np.int64)).to(
        resolve_device(device)), bvals=_to_device(bvals, device),
        block_size=int(block_size), n_rows=int(n_rows), n_cols=int(n_cols),
        nnz=int(nnz))


def relaxation_from_numpy(a: CsrHost, dinv, omega: float, sweeps: int,
                          params=None, device=None) -> Relaxation:
    """A computed port ``Relaxation`` on host matrix ``a`` whose state is
    the given padded inverse diagonal, damping factor and sweep count (the
    JAX one's ``dinv``, ``omega`` and ``sweeps``); more than one sweep packs
    ``a`` with ``choose_format`` in dinv's dtype, as ``compute()`` does."""
    m = Relaxation(a, params, device=device).initialize()
    m.set_state(_to_device(dinv, device), omega, sweeps)
    return m


def stencil_from_fields(dims, offsets, coeffs, n_rows_pad: int,
                        dtype="float32") -> StencilOp:
    """The port's StencilOp with the fields of the JAX package's one."""
    return StencilOp(dims=tuple(int(d) for d in dims),
                     offsets=tuple(tuple(int(o) for o in off)
                                   for off in offsets),
                     coeffs=tuple(float(c) for c in coeffs),
                     n_rows_pad=int(n_rows_pad), dtype=str(dtype))


def _level_dims(dims, n_levels: int):
    """Grid dims of each level of a structured hierarchy on ``dims``."""
    out = [tuple(int(d) for d in dims) + (1,) * (3 - len(dims))]
    for _ in range(n_levels - 1):
        block = structured_block(out[-1])
        out.append(tuple(d // b for d, b in zip(out[-1], block)))
    return out


def amg_state_from_jax(np_state: dict, dims, device=None) -> dict:
    """The port's ``SaAmg.state()`` from the JAX package's one with every
    array already numpy. ``dims`` is the fine grid; each level's operator
    is checked against the grid it must cover on that hierarchy."""
    levels = []
    grid = _level_dims(dims, len(np_state["levels"]))
    for s, g in zip(np_state["levels"], grid, strict=True):
        a = s["a"]
        if hasattr(a, "coeffs"):
            a_t = stencil_from_fields(a.dims, a.offsets, a.coeffs,
                                      a.n_rows_pad, a.dtype)
            if a_t.dims != g:
                raise ValueError(f"level stencil on {a_t.dims}, "
                                 f"expected grid {g}")
        else:
            a_t = dia_from_numpy(a.data, a.offsets, a.n_rows, a.n_cols,
                                 a.nnz, device)
            if a_t.n_rows != int(np.prod(g)):
                raise ValueError(f"level DIA has {a_t.n_rows} rows, "
                                 f"expected grid {g}")
        levels.append({"a": a_t, "dinv": torch.from_numpy(
            np.array(s["dinv"])).to(resolve_device(device))})
    coarse_inv = torch.from_numpy(np.array(np_state["coarse_inv"]))
    return {"levels": levels,
            "coarse_inv": coarse_inv.to(resolve_device(device))}


def block_amg_state_from_jax(np_state: dict, device=None) -> dict:
    """The port's ``BlockStructuredAmg.state()`` from the JAX package's one
    with every array already numpy: each level's BDIA operator (3-D
    lane-packed or 4-D data), Jacobi diagonal and tentative blocks ``q``,
    and the coarse pseudo-inverse. Apply it with the ``apply_state`` of a
    port hierarchy built on the same problem, which checks the level
    count."""
    levels = []
    for s in np_state["levels"]:
        a = s["a"]
        levels.append({
            "a": bdia_from_numpy(a.data, a.offsets, a.block_size, a.n_rows,
                                 a.n_cols, a.nnz, device),
            "dinv": _to_device(s["dinv"], device),
            "q": _to_device(s["q"], device)})
    return {"levels": levels,
            "coarse_inv": _to_device(np_state["coarse_inv"], device)}
