"""Cell geometry: Jacobians, reference<->physical maps, HGRAD transforms.

Counterpart of ``trilinos_tpu/fem/cell_tools.py``, a copy (the port imports
nothing of the JAX package) of its host form. Phalanx's workset
(``phalanx.PhysicsBlock``) is built with these host functions, as the JAX
package's is before it moves the tables to the device, so the port needs no
device form.

Reference: packages/intrepid2/src/Cell/Intrepid2_CellTools.hpp —
setJacobian/setJacobianInv/setJacobianDet, mapToPhysicalFrame — and
Intrepid2_FunctionSpaceTools (HGRADtransformGRAD).

All functions are batched over elements as single einsums: cell node
coordinates (ne, n_geo, dim) x reference-gradient tables (q, n_geo, dim)
-> Jacobians (ne, q, dim, dim), on numpy arrays.
"""

from __future__ import annotations

import numpy as np

from .basis import Basis, hgrad_basis
from .cells import CellTopology


def jacobian(cell_coords, ref_points, geom_basis: Basis):
    """J[e, q, i, j] = d x_i / d xi_j at each cubature point."""
    dphi = geom_basis.grads(ref_points)  # (q, n, d)
    return np.einsum("eni,qnj->eqij", cell_coords, dphi)


def jacobian_det(j):
    d = j.shape[-1]
    if d == 1:
        return j[..., 0, 0]
    if d == 2:
        return (j[..., 0, 0] * j[..., 1, 1]
                - j[..., 0, 1] * j[..., 1, 0])
    return (j[..., 0, 0] * (j[..., 1, 1] * j[..., 2, 2]
                            - j[..., 1, 2] * j[..., 2, 1])
            - j[..., 0, 1] * (j[..., 1, 0] * j[..., 2, 2]
                              - j[..., 1, 2] * j[..., 2, 0])
            + j[..., 0, 2] * (j[..., 1, 0] * j[..., 2, 1]
                              - j[..., 1, 1] * j[..., 2, 0]))


def jacobian_inv(j):
    """Closed-form small-matrix inverse (1x1/2x2/3x3), batched."""
    d = j.shape[-1]
    det = jacobian_det(j)[..., None, None]
    if d == 1:
        return 1.0 / j
    if d == 2:
        adj = np.stack([
            np.stack([j[..., 1, 1], -j[..., 0, 1]], axis=-1),
            np.stack([-j[..., 1, 0], j[..., 0, 0]], axis=-1)], axis=-2)
        return adj / det
    # cofactor/adjugate of 3x3
    c = np.stack([
        np.stack([j[..., 1, 1] * j[..., 2, 2] - j[..., 1, 2] * j[..., 2, 1],
                  j[..., 0, 2] * j[..., 2, 1] - j[..., 0, 1] * j[..., 2, 2],
                  j[..., 0, 1] * j[..., 1, 2] - j[..., 0, 2] * j[..., 1, 1]],
                 axis=-1),
        np.stack([j[..., 1, 2] * j[..., 2, 0] - j[..., 1, 0] * j[..., 2, 2],
                  j[..., 0, 0] * j[..., 2, 2] - j[..., 0, 2] * j[..., 2, 0],
                  j[..., 0, 2] * j[..., 1, 0] - j[..., 0, 0] * j[..., 1, 2]],
                 axis=-1),
        np.stack([j[..., 1, 0] * j[..., 2, 1] - j[..., 1, 1] * j[..., 2, 0],
                  j[..., 0, 1] * j[..., 2, 0] - j[..., 0, 0] * j[..., 2, 1],
                  j[..., 0, 0] * j[..., 1, 1] - j[..., 0, 1] * j[..., 1, 0]],
                 axis=-1)], axis=-2)
    return c / det


def map_to_physical(cell_coords, ref_points, geom_basis: Basis):
    """x[e, q, i] = sum_n coords[e, n, i] phi_n(xi_q)."""
    phi = geom_basis.values(ref_points)  # (q, n)
    return np.einsum("eni,qn->eqi", cell_coords, phi)


def hgrad_transform_grad(jinv, ref_grads):
    """Physical gradients: grad phi[e, q, n, i] = Jinv[e,q,j,i] dphi[q,n,j]
    (FunctionSpaceTools::HGRADtransformGRAD)."""
    return np.einsum("eqji,qnj->eqni", jinv, ref_grads)


def default_geom_basis(topo: CellTopology) -> Basis:
    return hgrad_basis(topo, 1)
