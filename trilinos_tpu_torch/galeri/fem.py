"""FE-based Galeri problems: elasticity, Helmholtz and UniFlow2D.

Counterpart of ``trilinos_tpu/galeri/fem.py`` (a copy: the port imports
nothing of the JAX package), the analogues of the reference's Xpetra-side
FE problems (Galeri_Elasticity2DProblem.hpp, Galeri_Elasticity3DProblem.hpp):

  * ``elasticity2d`` / ``elasticity3d`` — linear elasticity on Q1 quads /
    hexahedra with 2 / 3 dofs per node, closed-form element stiffness
    assembled on the host with ``ops.fe.fe_assemble``;
  * ``rigid_body_modes`` — their null space for smoothed aggregation;
  * ``helmholtz2d`` — Laplace2D − (k·h)² I;
  * ``uniflow2d`` — constant-velocity convection-diffusion, upwinded
    (Galeri_CrsMatrices.cpp "UniFlow2D").
"""
from __future__ import annotations

import numpy as np

from ..ops.fe import fe_assemble
from ..ops.formats import CsrHost
from ..ops.matrix_ops import spadd
from .stencils import _emit, cross2d_stencil


def _q1_elasticity_ke(e_mod: float, nu: float) -> np.ndarray:
    """8×8 plane-strain Q1 element stiffness (unit square element),
    2×2 Gauss quadrature; dof order (ux0, uy0, ux1, uy1, ...) with nodes
    (0,0),(1,0),(1,1),(0,1)."""
    lam = e_mod * nu / ((1 + nu) * (1 - 2 * nu))
    mu = e_mod / (2 * (1 + nu))
    d_mat = np.array([[lam + 2 * mu, lam, 0],
                      [lam, lam + 2 * mu, 0],
                      [0, 0, mu]])
    gp = np.array([-1, 1]) / np.sqrt(3.0)
    nodes = np.array([[0.0, 0], [1, 0], [1, 1], [0, 1]])
    ke = np.zeros((8, 8))
    for xi in gp:
        for eta in gp:
            s, t = (xi + 1) / 2, (eta + 1) / 2  # map to [0,1]^2
            dn = np.array([  # dN/ds, dN/dt for the 4 bilinear shapes
                [-(1 - t), -(1 - s)],
                [(1 - t), -s],
                [t, s],
                [-t, (1 - s)],
            ])
            b_mat = np.zeros((3, 8))
            for a in range(4):
                b_mat[0, 2 * a] = dn[a, 0]
                b_mat[1, 2 * a + 1] = dn[a, 1]
                b_mat[2, 2 * a] = dn[a, 1]
                b_mat[2, 2 * a + 1] = dn[a, 0]
            # unit element: |J| = 1/4 per GP pair weight (2x2 rule, w=1 in
            # xi-space; ds/dxi = 1/2 each)
            ke += 0.25 * b_mat.T @ d_mat @ b_mat
    return ke


def elasticity2d(nx: int, ny: int, e_mod: float = 1e9, nu: float = 0.25,
                 dtype=np.float64) -> CsrHost:
    """Plane-strain elasticity on an (nx-1)×(ny-1)-element Q1 grid of
    nx×ny nodes → 2·nx·ny dofs. Dirichlet handled by the usual Galeri
    convention (no boundary elimination — the operator is the assembled
    Neumann stiffness plus a diagonal shift on the boundary nodes to keep
    it SPD, matching the reference's default usable-out-of-the-box form).
    """
    ke = _q1_elasticity_ke(e_mod, nu).astype(dtype)
    ex, ey = nx - 1, ny - 1
    # element -> its 4 node ids (lexicographic nodes, x fastest)
    e_i, e_j = np.meshgrid(np.arange(ex), np.arange(ey), indexing="ij")
    n0 = (e_j * nx + e_i).reshape(-1)
    enodes = np.stack([n0, n0 + 1, n0 + nx + 1, n0 + nx], axis=1)
    # node ids -> dof ids (ux, uy interleaved)
    connect = np.empty((enodes.shape[0], 8), dtype=np.int64)
    connect[:, 0::2] = 2 * enodes
    connect[:, 1::2] = 2 * enodes + 1
    mats = np.broadcast_to(ke, (enodes.shape[0], 8, 8))
    a = fe_assemble(connect, mats, 2 * nx * ny)
    # SPD shift on boundary-node dofs (pin rigid-body modes)
    ii, jj = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    boundary = ((ii == 0) | (ii == nx - 1) | (jj == 0)
                | (jj == ny - 1)).reshape(-1, order="F")
    nodes_b = np.nonzero(boundary)[0]
    dofs = np.concatenate([2 * nodes_b, 2 * nodes_b + 1])
    shift = float(e_mod)
    d = CsrHost.from_coo(dofs, dofs, shift * np.ones(len(dofs), dtype=dtype),
                         a.shape, sum_duplicates=True)
    return spadd(a, d)


def _q1_elasticity3d_ke(e_mod: float, nu: float) -> np.ndarray:
    """24×24 Q1 hexahedral element stiffness (unit cube element),
    2×2×2 Gauss quadrature; dof order (ux0, uy0, uz0, ux1, ...) with
    nodes (0,0,0),(1,0,0),(1,1,0),(0,1,0) then the z=1 copies — the
    isotropic 3-D elasticity element of Galeri_Elasticity3DProblem.hpp."""
    lam = e_mod * nu / ((1 + nu) * (1 - 2 * nu))
    mu = e_mod / (2 * (1 + nu))
    d_mat = np.zeros((6, 6))
    d_mat[:3, :3] = lam
    d_mat[np.arange(3), np.arange(3)] = lam + 2 * mu
    d_mat[3:, 3:] = mu * np.eye(3)
    gp = np.array([-1, 1]) / np.sqrt(3.0)
    base = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], dtype=float)
    ke = np.zeros((24, 24))
    for xi in gp:
        for eta in gp:
            for zeta in gp:
                s, t, u = (xi + 1) / 2, (eta + 1) / 2, (zeta + 1) / 2
                dn = np.zeros((8, 3))
                for a in range(8):
                    sx, sy = base[a % 4]
                    sz = float(a // 4)
                    fx = sx * s + (1 - sx) * (1 - s)
                    fy = sy * t + (1 - sy) * (1 - t)
                    fz = sz * u + (1 - sz) * (1 - u)
                    gx = 2 * sx - 1   # d fx / ds
                    gy = 2 * sy - 1
                    gz = 2 * sz - 1
                    dn[a] = (gx * fy * fz, fx * gy * fz, fx * fy * gz)
                b_mat = np.zeros((6, 24))
                for a in range(8):
                    c = 3 * a
                    b_mat[0, c] = dn[a, 0]
                    b_mat[1, c + 1] = dn[a, 1]
                    b_mat[2, c + 2] = dn[a, 2]
                    b_mat[3, c] = dn[a, 1]      # γ_xy
                    b_mat[3, c + 1] = dn[a, 0]
                    b_mat[4, c + 1] = dn[a, 2]  # γ_yz
                    b_mat[4, c + 2] = dn[a, 1]
                    b_mat[5, c] = dn[a, 2]      # γ_zx
                    b_mat[5, c + 2] = dn[a, 0]
                ke += 0.125 * b_mat.T @ d_mat @ b_mat  # |J| = (1/2)^3
    return ke


def elasticity3d(nx: int, ny: int, nz: int, e_mod: float = 1e9,
                 nu: float = 0.25, dtype=np.float64) -> CsrHost:
    """Isotropic 3-D elasticity on an (nx-1)×(ny-1)×(nz-1)-element Q1
    hex grid of nx·ny·nz nodes → 3·nx·ny·nz dofs
    (Galeri_Elasticity3DProblem.hpp). Same Galeri convention as
    ``elasticity2d``: assembled Neumann stiffness + SPD diagonal shift
    on boundary-node dofs. Interior nodes couple to 27 neighbours →
    a constant-block-offset (BDIA-packable, block b=3) structure."""
    ke = _q1_elasticity3d_ke(e_mod, nu).astype(dtype)
    ex, ey, ez = nx - 1, ny - 1, nz - 1
    e_i, e_j, e_k = np.meshgrid(np.arange(ex), np.arange(ey),
                                np.arange(ez), indexing="ij")
    n0 = (e_k * (nx * ny) + e_j * nx + e_i).reshape(-1)
    bottom = np.stack([n0, n0 + 1, n0 + nx + 1, n0 + nx], axis=1)
    enodes = np.concatenate([bottom, bottom + nx * ny], axis=1)
    connect = np.empty((enodes.shape[0], 24), dtype=np.int64)
    for c in range(3):
        connect[:, c::3] = 3 * enodes + c
    mats = np.broadcast_to(ke, (enodes.shape[0], 24, 24))
    a = fe_assemble(connect, mats, 3 * nx * ny * nz)
    ii, jj, kk = np.meshgrid(np.arange(nx), np.arange(ny),
                             np.arange(nz), indexing="ij")
    boundary = ((ii == 0) | (ii == nx - 1) | (jj == 0) | (jj == ny - 1)
                | (kk == 0) | (kk == nz - 1))
    # node id = ix + nx*(iy + ny*iz): x fastest — flatten accordingly
    nodes_b = np.nonzero(boundary.transpose(2, 1, 0).reshape(-1))[0]
    dofs = np.concatenate([3 * nodes_b, 3 * nodes_b + 1,
                           3 * nodes_b + 2])
    shift = float(e_mod)
    d = CsrHost.from_coo(dofs, dofs,
                         shift * np.ones(len(dofs), dtype=dtype),
                         a.shape, sum_duplicates=True)
    return spadd(a, d)


def rigid_body_modes(nx: int, ny: int, nz: int | None = None) -> np.ndarray:
    """Rigid-body modes of the elasticity grids — the null-space input
    for smoothed-aggregation AMG (MueLu "Nullspace"; the reference's
    Galeri elasticity problems ship these as `problem->BuildNullspace()`,
    Galeri_Elasticity3DProblem.hpp). Node coordinates are the unit-spaced
    lexicographic grid (node = ix + nx·(iy + ny·iz)), dofs interleaved —
    matching ``elasticity2d`` / ``elasticity3d``.

    Returns (2·n, 3) for 2-D (two translations + in-plane rotation) or
    (3·n, 6) for 3-D (three translations + three rotations)."""
    if nz is None:
        n = nx * ny
        idx = np.arange(n)
        x = (idx % nx).astype(np.float64) - (nx - 1) / 2.0
        y = (idx // nx).astype(np.float64) - (ny - 1) / 2.0
        ns = np.zeros((2 * n, 3))
        ns[0::2, 0] = 1.0
        ns[1::2, 1] = 1.0
        ns[0::2, 2] = -y
        ns[1::2, 2] = x
        return ns
    n = nx * ny * nz
    idx = np.arange(n)
    x = (idx % nx).astype(np.float64) - (nx - 1) / 2.0
    y = ((idx // nx) % ny).astype(np.float64) - (ny - 1) / 2.0
    z = (idx // (nx * ny)).astype(np.float64) - (nz - 1) / 2.0
    ns = np.zeros((3 * n, 6))
    ns[0::3, 0] = 1.0
    ns[1::3, 1] = 1.0
    ns[2::3, 2] = 1.0
    ns[0::3, 3] = -y        # rotation about z
    ns[1::3, 3] = x
    ns[1::3, 4] = -z        # rotation about x
    ns[2::3, 4] = y
    ns[0::3, 5] = z         # rotation about y
    ns[2::3, 5] = -x
    return ns


def helmholtz2d(nx: int, ny: int, k: float = 1.0, h: float | None = None,
                dtype=np.float64, fmt: str = "csr", device=None):
    """Shifted Laplacian Helmholtz operator: A = Laplace2D − (k·h)² I."""
    h = h if h is not None else 1.0 / (nx + 1)
    shift = (k * h) ** 2
    st = cross2d_stencil(4.0 - shift, -1.0, -1.0, -1.0, -1.0)
    return _emit((nx, ny), st, dtype, fmt, device)


def uniflow2d(nx: int, ny: int, lx: float = 1.0, ly: float = 1.0,
              conv: float = 1.0, diff: float = 1e-5, alpha: float = 0.0,
              dtype=np.float64, fmt: str = "csr", device=None):
    """Constant-velocity convection-diffusion (UniFlow2D,
    packages/galeri/src-epetra/Galeri_CrsMatrices.cpp): velocity
    (cos α, sin α)·conv, upwind discretization like Recirc2D."""
    hx = lx / (nx + 1)
    hy = ly / (ny + 1)
    cx = conv * np.cos(alpha) / hx
    cy = conv * np.sin(alpha) / hy
    a = diff * 2 / hx ** 2 + diff * 2 / hy ** 2
    b = -diff / hx ** 2
    c = -diff / hx ** 2
    d = -diff / hy ** 2
    e = -diff / hy ** 2
    if cx < 0:
        c += cx
        a -= cx
    else:
        b -= cx
        a += cx
    if cy < 0:
        e += cy
        a -= cy
    else:
        d -= cy
        a += cy
    st = cross2d_stencil(a, b, c, d, e)
    return _emit((nx, ny), st, dtype, fmt, device)
