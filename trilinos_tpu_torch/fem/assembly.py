"""Batched FE assembly: stiffness/mass/load + a Poisson driver.

Counterpart of ``trilinos_tpu/fem/assembly.py``, a copy (the port imports
nothing of the JAX package) with the same results bit for bit, but that
``poisson_dirichlet`` takes the geometry and the dof numbering once for K
and the load, and can hand back the element matrices.

Reference: the Intrepid2 assembly idiom (e.g.
packages/trilinoscouplings/examples/scaling/example_Poisson.cpp — compute
cell Jacobians, transform gradients, integrate, assemble into a CRS) —
here each step is ONE einsum batched over all elements, and the global
insert is the vectorized COO Export-sum from ``ops.fe``.

Element integrals (w = cubature weight x |detJ|):
  stiffness K_e[a,b] = sum_q w a(x_q) grad phi_a . grad phi_b
  mass      M_e[a,b] = sum_q w phi_a phi_b
  load      f_e[a]   = sum_q w f(x_q) phi_a
"""

from __future__ import annotations

import numpy as np

from ..ops.fe import fe_assemble
from .basis import Basis, hgrad_basis
from .cell_tools import (hgrad_transform_grad, jacobian, jacobian_det,
                         jacobian_inv, map_to_physical)
from .cubature import cubature
from .mesh import Mesh, fe_space


def _setup(mesh: Mesh, basis: Basis, quad_degree: int | None):
    deg = quad_degree if quad_degree is not None else 2 * basis.degree
    qp, qw = cubature(mesh.topo, deg)
    geom = hgrad_basis(mesh.topo, 1)
    cc = mesh.cell_coords
    j = jacobian(cc, qp, geom)
    w = qw[None, :] * np.abs(jacobian_det(j))       # (ne, q)
    xq = map_to_physical(cc, qp, geom)              # (ne, q, dim)
    return qp, w, xq, j


def _stiffness(basis: Basis, geo, coeff) -> np.ndarray:
    qp, w, xq, j = geo
    gphys = hgrad_transform_grad(jacobian_inv(j), basis.grads(qp))
    if coeff is not None:
        w = w * np.asarray(coeff(xq))
    return np.einsum("eq,eqai,eqbi->eab", w, gphys, gphys, optimize=True)


def _load(basis: Basis, geo, f, conn, n_dofs: int) -> np.ndarray:
    qp, w, xq, _ = geo
    phi = basis.values(qp)
    fe = np.einsum("eq,eq,qa->ea", w, np.asarray(f(xq)), phi,
                   optimize=True)
    out = np.zeros(n_dofs)
    np.add.at(out, conn.ravel(), fe.ravel())
    return out


def stiffness_matrix(mesh: Mesh, basis: Basis | None = None, coeff=None,
                     quad_degree: int | None = None):
    """(CsrHost K, dof_connect, dof_coords); ``coeff(x)``: scalar
    diffusion coefficient at physical points (ne, q, dim) -> (ne, q)."""
    basis = basis or hgrad_basis(mesh.topo, 1)
    ke = _stiffness(basis, _setup(mesh, basis, quad_degree), coeff)
    conn, dof_xy = fe_space(mesh, basis)
    return fe_assemble(conn, ke, len(dof_xy)), conn, dof_xy


def mass_matrix(mesh: Mesh, basis: Basis | None = None,
                quad_degree: int | None = None):
    basis = basis or hgrad_basis(mesh.topo, 1)
    qp, w, _, _ = _setup(mesh, basis, quad_degree)
    phi = basis.values(qp)  # (q, n)
    me = np.einsum("eq,qa,qb->eab", w, phi, phi, optimize=True)
    conn, dof_xy = fe_space(mesh, basis)
    return fe_assemble(conn, me, len(dof_xy)), conn, dof_xy


def load_vector(mesh: Mesh, f, basis: Basis | None = None,
                quad_degree: int | None = None):
    """Global load for ``f(x)``: (ne, q, dim) -> (ne, q)."""
    basis = basis or hgrad_basis(mesh.topo, 1)
    conn, dof_xy = fe_space(mesh, basis)
    out = _load(basis, _setup(mesh, basis, quad_degree), f, conn,
                len(dof_xy))
    return out, conn, dof_xy


def poisson_dirichlet(mesh: Mesh, f, basis: Basis | None = None,
                      coeff=None, g=None, *, elements: bool = False):
    """-div(a grad u) = f with Dirichlet data g on the boundary of the
    unit box: returns (K_ii CsrHost, rhs, interior_ids, dof_coords) —
    boundary rows eliminated symmetrically (the standard condensation).
    ``elements=True`` also returns the element stiffness matrices and the
    dof connectivity that K was assembled from, (…, K_e, dof_connect),
    for a matrix-free apply of the same operator."""
    basis = basis or hgrad_basis(mesh.topo, 1)
    # the geometry and the dof numbering once, for K and the load alike
    geo = _setup(mesh, basis, None)
    ke = _stiffness(basis, geo, coeff)
    conn, xy = fe_space(mesh, basis)
    k = fe_assemble(conn, ke, len(xy))
    b = _load(basis, geo, f, conn, len(xy))
    on_bnd = np.zeros(len(xy), bool)
    for d in range(xy.shape[1]):
        on_bnd |= (np.abs(xy[:, d]) < 1e-9) | (np.abs(xy[:, d] - 1) < 1e-9)
    interior = np.nonzero(~on_bnd)[0]
    if g is not None:
        ubnd = np.zeros(len(xy))
        ubnd[on_bnd] = g(xy[on_bnd])
        b = b - k.matvec_host(ubnd)
    kii = k.submatrix(interior, interior)
    if elements:
        return kii, b[interior], interior, xy, ke, conn
    return kii, b[interior], interior, xy
