"""Galeri-equivalent stencil problem generators.

Counterpart of ``trilinos_tpu/galeri/stencils.py`` (a copy of its host
code): Laplace1D/2D/3D, Star2D, BigStar2D, Brick3D, Recirc2D, the
``create_matrix`` string factory (Galeri's CreateCrsMatrix) and the
Maxwell2D curl-curl problem. Operators are emitted in closed form as host
CSR, as device DIA, or as a matrix-free :class:`StencilOp`.

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


def big_star2d_stencil(a, b, c, d, e, z1, z2, z3, z4, bb, cc, dd,
                       ee) -> Stencil:
    # Galeri BigStar2D: 13-point (star + distance-2 cross)
    return star2d_stencil(a, b, c, d, e, z1, z2, z3, z4) + [
        ((-2, 0), bb), ((2, 0), cc), ((0, -2), dd), ((0, 2), ee)]


def cross3d_stencil(a, b, c, d, e, f, g) -> Stencil:
    # Galeri Cross3D: b/c left-right, d/e lower-upper, f/g below-above
    return [((0, 0, 0), a), ((-1, 0, 0), b), ((1, 0, 0), c),
            ((0, -1, 0), d), ((0, 1, 0), e), ((0, 0, -1), f), ((0, 0, 1), g)]


def brick3d_stencil(a, b, c, d) -> Stencil:
    """27-point stencil: center a, faces b, edges c, corners d (Galeri
    Brick3D)."""
    st = []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                st.append(((dx, dy, dz),
                           (a, b, c, d)[abs(dx) + abs(dy) + abs(dz)]))
    return st


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


def star2d(nx: int, ny: int, a=5.0, b=-1.0, c=-1.0, d=-1.0, e=-1.0,
           z1=-0.25, z2=-0.25, z3=-0.25, z4=-0.25, dtype=np.float64,
           fmt: str = "csr", device=None):
    return _emit((nx, ny), star2d_stencil(a, b, c, d, e, z1, z2, z3, z4),
                 dtype, fmt, device)


def big_star2d(nx: int, ny: int, dtype=np.float64, fmt: str = "csr",
               device=None):
    """Galeri's default coefficients: BigStar2D(20, -8 ×4, 2 ×4, 1 ×4)."""
    st = big_star2d_stencil(20.0, -8.0, -8.0, -8.0, -8.0,
                            2.0, 2.0, 2.0, 2.0, 1.0, 1.0, 1.0, 1.0)
    return _emit((nx, ny), st, dtype, fmt, device)


def brick3d(nx: int, ny: int, nz: int, dtype=np.float64, fmt: str = "csr",
            device=None):
    """27-point Brick3D with the standard (26, -1) fill."""
    return _emit((nx, ny, nz), brick3d_stencil(26.0, -1.0, -1.0, -1.0),
                 dtype, fmt, device)


def recirc2d(nx: int, ny: int, lx=1.0, ly=1.0, conv=1.0, diff=1e-5,
             dtype=np.float64, fmt: str = "csr", device=None):
    """Recirculating convection-diffusion, upwinded (Galeri Recirc2D): the
    nonsymmetric model problem."""
    hx = lx / (nx + 1)
    hy = ly / (ny + 1)

    def fields(ix, iy):
        x = hx * (ix + 1)
        y = hy * (iy + 1)
        conv_x = conv * 4 * x * (x - 1.0) * (1.0 - 2 * y) / hx
        conv_y = -conv * 4 * y * (y - 1.0) * (1.0 - 2 * x) / hy
        a = np.zeros_like(x)
        b = np.zeros_like(x)
        c = np.zeros_like(x)
        d = np.zeros_like(x)
        e = np.zeros_like(x)
        neg_x = conv_x < 0
        c += np.where(neg_x, conv_x, 0.0)
        a -= np.where(neg_x, conv_x, 0.0)
        b -= np.where(~neg_x, conv_x, 0.0)
        a += np.where(~neg_x, conv_x, 0.0)
        neg_y = conv_y < 0
        e += np.where(neg_y, conv_y, 0.0)
        a -= np.where(neg_y, conv_y, 0.0)
        d -= np.where(~neg_y, conv_y, 0.0)
        a += np.where(~neg_y, conv_y, 0.0)
        a += diff * 2.0 / (hx * hx) + diff * 2.0 / (hy * hy)
        b -= diff / (hx * hx)
        c -= diff / (hx * hx)
        d -= diff / (hy * hy)
        e -= diff / (hy * hy)
        return a, b, c, d, e

    def pick(i):
        return lambda ix, iy: fields(ix.astype(float), iy.astype(float))[i]

    st = [((0, 0), pick(0)), ((-1, 0), pick(1)), ((1, 0), pick(2)),
          ((0, -1), pick(3)), ((0, 1), pick(4))]
    return _emit((nx, ny), st, dtype, fmt, device)


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


def create_matrix(name: str, params: dict, dtype=np.float64,
                  fmt: str = "csr", device=None):
    """String factory over the Galeri problems (Galeri's CreateCrsMatrix
    name dispatch); ``params`` holds nx, ny, nz and the problem's own
    parameters. The finite-element problems come from :mod:`.fem`, and
    maxwell2d returns the pair (A, G)."""
    from . import fem

    p = dict(params)
    nx, ny, nz = p.get("nx"), p.get("ny"), p.get("nz")
    key = name.lower()
    if key == "laplace1d":
        return laplace1d(nx, dtype, fmt, device)
    if key == "laplace2d":
        return laplace2d(nx, ny, dtype, fmt, device)
    if key == "laplace3d":
        return laplace3d(nx, ny, nz, dtype, fmt, device)
    if key == "star2d":
        return star2d(nx, ny, dtype=dtype, fmt=fmt, device=device)
    if key == "bigstar2d":
        return big_star2d(nx, ny, dtype, fmt, device)
    if key == "brick3d":
        return brick3d(nx, ny, nz, dtype, fmt, device)
    if key == "recirc2d":
        return recirc2d(nx, ny, conv=p.get("conv", 1.0),
                        diff=p.get("diff", 1e-5), dtype=dtype, fmt=fmt,
                        device=device)
    if key == "cross2d":
        st = cross2d_stencil(p["a"], p["b"], p["c"], p["d"], p["e"])
        return _emit((nx, ny), st, dtype, fmt, device)
    if key == "elasticity2d":
        return fem.elasticity2d(nx, ny, e_mod=p.get("E", 1e9),
                                nu=p.get("nu", 0.25))
    if key == "helmholtz2d":
        return fem.helmholtz2d(nx, ny, k=p.get("k", 1.0), fmt=fmt,
                               device=device)
    if key == "uniflow2d":
        return fem.uniflow2d(nx, ny, conv=p.get("conv", 1.0),
                             diff=p.get("diff", 1e-5),
                             alpha=p.get("alpha", 0.0))
    if key == "maxwell2d":
        return maxwell2d(nx, ny, sigma=p.get("sigma", 1.0))
    raise ValueError(f"unknown Galeri matrix type {name!r}")


def maxwell2d(nx: int, ny: int, sigma=1.0, dtype=np.float64):
    """2-D eddy-current (curl-curl) problem on edge unknowns: A = CᵀC + σ·I
    and the discrete gradient G (edges × nodes) whose range spans
    curl-curl's null space (the Hiptmair smoother's target problem).
    x-edges (nx·(ny+1)) are numbered first, then y-edges ((nx+1)·ny).
    Returns (A, G) as host CSR."""
    from ..ops.matrix_ops import diag_matrix, spadd, spgemm

    n_nodes = (nx + 1) * (ny + 1)
    n_ex = nx * (ny + 1)
    n_e = n_ex + (nx + 1) * ny
    # gradient: each edge gets +1 at its head node, -1 at its tail
    i, j = np.meshgrid(np.arange(nx), np.arange(ny + 1), indexing="xy")
    ex, ex_tail = (i + nx * j).ravel(), (i + (nx + 1) * j).ravel()
    i, j = np.meshgrid(np.arange(nx + 1), np.arange(ny), indexing="xy")
    ey, ey_tail = (n_ex + i + (nx + 1) * j).ravel(), (i + (nx + 1) * j).ravel()
    rows_g = np.stack([np.r_[ex, ey], np.r_[ex, ey]], axis=1).ravel()
    cols_g = np.stack([np.r_[ex_tail + 1, ey_tail + nx + 1],
                       np.r_[ex_tail, ey_tail]], axis=1).ravel()
    vals_g = np.tile([1.0, -1.0], n_e).astype(dtype)
    g = CsrHost.from_coo(rows_g, cols_g, vals_g, (n_e, n_nodes))
    # curl: each face sums its four edges counter-clockwise
    i, j = np.meshgrid(np.arange(nx), np.arange(ny), indexing="xy")
    i, j = i.ravel(), j.ravel()
    f = i + nx * j
    rows_c = np.repeat(f, 4)
    cols_c = np.stack([i + nx * j, n_ex + (i + 1) + (nx + 1) * j,
                       i + nx * (j + 1), n_ex + i + (nx + 1) * j],
                      axis=1).ravel()
    vals_c = np.tile([1.0, 1.0, -1.0, -1.0], nx * ny).astype(dtype)
    c = CsrHost.from_coo(rows_c, cols_c, vals_c, (nx * ny, n_e))
    sig = (np.full(n_e, float(sigma)) if np.isscalar(sigma)
           else np.asarray(sigma, dtype=np.float64))
    return spadd(spgemm(c.transpose(), c), diag_matrix(sig), 1.0, 1.0), g
