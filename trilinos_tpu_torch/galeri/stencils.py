"""Galeri-equivalent stencil problem generators.

Counterpart of ``trilinos_tpu/galeri/stencils.py`` (a copy of its host
code). Operators are emitted in closed form as host CSR, as device DIA,
or as a matrix-free :class:`StencilOp`.

Grid numbering is lexicographic, gid = ix + nx*(iy + ny*iz); boundaries
are Dirichlet-truncated (out-of-range neighbours are absent).
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from ..device import numpy_dtype
from ..ops.formats import CsrHost, DiaMatrix, ROW_ALIGN, dia_from_host, round_up
from ..ops.stencil_op import StencilOp

# A stencil is a list of (grid_offset, coefficient) pairs; the coefficient is
# a scalar or a callable mapping coordinate arrays (ix, iy, ...) -> values.
Stencil = Sequence[tuple[tuple[int, ...], float | Callable]]


def _grid_coords(dims: tuple[int, ...]):
    """Coordinate arrays of shape (n_total,), first dim fastest."""
    idx = np.arange(int(np.prod(dims)), dtype=np.int64)
    coords = []
    for d in dims:
        coords.append(idx % d)
        idx = idx // d
    return coords


def _coeff_values(coeff, coords) -> np.ndarray:
    if callable(coeff):
        return np.asarray(coeff(*coords), dtype=np.float64)
    return np.full(coords[0].shape, float(coeff))


def _valid(coords, off, dims) -> np.ndarray:
    valid = np.ones(coords[0].shape, dtype=bool)
    for c, o, d in zip(coords, off, dims):
        if o:
            valid &= (c + o >= 0) & (c + o < d)
    return valid


def _lin(off, dims) -> int:
    lin, stride = 0, 1
    for o, d in zip(off, dims):
        lin += o * stride
        stride *= d
    return lin


def stencil_csr(dims: tuple[int, ...], stencil: Stencil,
                dtype=np.float64) -> CsrHost:
    """Assemble a stencil operator as host CSR (vectorized, no insert loop)."""
    n = int(np.prod(dims))
    coords = _grid_coords(dims)
    idx = np.arange(n, dtype=np.int64)
    rows_all, cols_all, vals_all = [], [], []
    for off, coeff in stencil:
        valid = _valid(coords, off, dims)
        vals = _coeff_values(coeff, coords).astype(dtype)
        rows_all.append(idx[valid])
        cols_all.append(idx[valid] + _lin(off, dims))
        vals_all.append(vals[valid])
    return CsrHost.from_coo(np.concatenate(rows_all), np.concatenate(cols_all),
                            np.concatenate(vals_all), (n, n),
                            sum_duplicates=True)


def stencil_dia(dims: tuple[int, ...], stencil: Stencil, dtype=np.float64,
                n_rows_pad: int | None = None, identity_pad: bool = True,
                device=None) -> DiaMatrix:
    """Assemble a stencil operator directly as a DiaMatrix on ``device``.

    Each stencil offset maps to one linear diagonal offset; boundary-invalid
    positions are zero in the data array."""
    n = int(np.prod(dims))
    if n_rows_pad is None:
        n_rows_pad = round_up(n, ROW_ALIGN)
    coords = _grid_coords(dims)
    host_dt = numpy_dtype(dtype)
    by_off: dict[int, np.ndarray] = {}
    nnz = 0
    for off, coeff in stencil:
        lin = _lin(off, dims)
        valid = np.ones(n, dtype=bool)
        for c, o, d in zip(coords, off, dims):
            valid &= (c + o >= 0) & (c + o < d)
        vals = np.where(valid, _coeff_values(coeff, coords),
                        0.0).astype(host_dt)
        nnz += int(valid.sum())
        by_off[lin] = by_off[lin] + vals if lin in by_off else vals
    offsets = tuple(sorted(by_off))
    data = np.zeros((len(offsets), n_rows_pad), dtype=host_dt)
    for i, o in enumerate(offsets):
        data[i, :n] = by_off[o]
    if identity_pad and 0 in by_off and n_rows_pad > n:
        data[offsets.index(0), n:] = 1.0
    return dia_from_host(data, offsets, n, n, nnz, dtype, device)


def cross2d_stencil(a, b, c, d, e) -> Stencil:
    #     e            (Galeri Cross2D: b left, c right, d lower, e upper)
    #   b a c
    #     d
    return [((0, 0), a), ((-1, 0), b), ((1, 0), c), ((0, -1), d), ((0, 1), e)]


def star2d_stencil(a, b, c, d, e, z1, z2, z3, z4) -> Stencil:
    # Galeri Star2D corners z1..z4 = (lower-1, lower+1, upper-1, upper+1)
    return cross2d_stencil(a, b, c, d, e) + [
        ((-1, -1), z1), ((1, -1), z2), ((-1, 1), z3), ((1, 1), z4)]


def cross3d_stencil(a, b, c, d, e, f, g) -> Stencil:
    # Galeri Cross3D: b/c left-right, d/e lower-upper, f/g below-above
    return [((0, 0, 0), a), ((-1, 0, 0), b), ((1, 0, 0), c),
            ((0, -1, 0), d), ((0, 1, 0), e), ((0, 0, -1), f), ((0, 0, 1), g)]


def laplace1d(n: int, dtype=np.float64, fmt: str = "csr", device=None):
    st = [((0,), 2.0), ((-1,), -1.0), ((1,), -1.0)]
    return _emit((n,), st, dtype, fmt, device)


def laplace2d(nx: int, ny: int, dtype=np.float64, fmt: str = "csr",
              device=None):
    """Laplace2D = Cross2D(4, -1, -1, -1, -1)."""
    return _emit((nx, ny), cross2d_stencil(4.0, -1.0, -1.0, -1.0, -1.0),
                 dtype, fmt, device)


def laplace3d(nx: int, ny: int, nz: int, dtype=np.float64, fmt: str = "csr",
              device=None):
    """Laplace3D = Cross3D(6, -1 ×6)."""
    return _emit((nx, ny, nz), cross3d_stencil(6.0, *([-1.0] * 6)), dtype,
                 fmt, device)


def _emit(dims, st, dtype, fmt, device):
    """``device`` places the stored ``"dia"`` form; ``"csr"`` is host
    numpy and ``"stencil"`` holds no arrays, so neither takes one."""
    if fmt != "dia" and device is not None:
        raise ValueError(f"fmt={fmt!r} places no tensors; device= applies "
                         "to fmt='dia' only")
    if fmt == "csr":
        return stencil_csr(dims, st, dtype)
    if fmt == "dia":
        return stencil_dia(dims, st, dtype, device=device)
    if fmt == "stencil":
        if any(callable(c) for _, c in st):
            raise ValueError("fmt='stencil' requires constant coefficients")
        return StencilOp.create(dims, st, dtype=str(np.dtype(dtype)))
    raise ValueError(f"unknown fmt {fmt!r}")
