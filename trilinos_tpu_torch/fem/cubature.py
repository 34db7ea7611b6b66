"""Cubature rules on reference cells (the Intrepid2 Integration analogue).

Counterpart of ``trilinos_tpu/fem/cubature.py``, a copy (the port imports
nothing of the JAX package).

Reference: packages/intrepid2/src/Discretization/Integration —
Intrepid2_CubatureDirectTriDefault.hpp / ...TetDefault.hpp (tabulated
symmetric simplex rules) and Intrepid2_CubatureTensor.hpp (tensor
products of 1-D Gauss rules for line/quad/hex).

Tensor cells get Gauss-Legendre products of any degree. Simplex rules
are the classical symmetric ones (Strang/Grundmann tables, standard
published constants) up to the degrees FE assembly here needs
(degree 5 tri, degree 3 tet); higher degrees raise.
"""

from __future__ import annotations

import itertools

import numpy as np

from .cells import CellTopology


def _gauss_tensor(dim: int, degree: int):
    n1 = degree // 2 + 1
    x, w = np.polynomial.legendre.leggauss(n1)
    pts = np.array(list(itertools.product(x, repeat=dim)))
    wts = np.array([np.prod(c) for c in itertools.product(w, repeat=dim)])
    return pts.reshape(-1, dim), wts


# classical symmetric triangle rules: (barycentric-orbit points, weights
# summing to the reference area 1/2)
def _tri_rule(degree: int):
    if degree <= 1:
        return np.array([[1 / 3, 1 / 3]]), np.array([0.5])
    if degree <= 2:  # 3-point midpoint-of-edge rule
        pts = np.array([[0.5, 0.0], [0.5, 0.5], [0.0, 0.5]])
        return pts, np.full(3, 1 / 6)
    if degree <= 3:  # 4-point (Strang)
        pts = np.array([[1 / 3, 1 / 3], [0.6, 0.2], [0.2, 0.6], [0.2, 0.2]])
        wts = np.array([-27 / 96, 25 / 96, 25 / 96, 25 / 96])
        return pts, wts
    if degree <= 5:  # 7-point
        a = (6 + np.sqrt(15)) / 21
        b = (6 - np.sqrt(15)) / 21
        wa = (155 + np.sqrt(15)) / 2400
        wb = (155 - np.sqrt(15)) / 2400
        pts = np.array([[1 / 3, 1 / 3],
                        [a, a], [1 - 2 * a, a], [a, 1 - 2 * a],
                        [b, b], [1 - 2 * b, b], [b, 1 - 2 * b]])
        wts = np.array([9 / 80, wa, wa, wa, wb, wb, wb])
        return pts, wts
    raise NotImplementedError(f"tri cubature degree {degree}")


def _tet_rule(degree: int):
    if degree <= 1:
        return np.array([[0.25, 0.25, 0.25]]), np.array([1 / 6])
    if degree <= 2:  # 4-point symmetric
        a = (5 + 3 * np.sqrt(5)) / 20
        b = (5 - np.sqrt(5)) / 20
        pts = np.array([[a, b, b], [b, a, b], [b, b, a], [b, b, b]])
        return pts, np.full(4, 1 / 24)
    if degree <= 3:  # 5-point
        pts = np.array([[0.25, 0.25, 0.25],
                        [0.5, 1 / 6, 1 / 6], [1 / 6, 0.5, 1 / 6],
                        [1 / 6, 1 / 6, 0.5], [1 / 6, 1 / 6, 1 / 6]])
        wts = np.array([-2 / 15, 3 / 40, 3 / 40, 3 / 40, 3 / 40])
        return pts, wts
    raise NotImplementedError(f"tet cubature degree {degree}")


def cubature(topo: CellTopology, degree: int):
    """(points (Q, dim), weights (Q,)) integrating polynomials of the
    given total degree exactly on the reference cell."""
    if topo.family == "tensor":
        return _gauss_tensor(topo.dim, degree)
    if topo.name == "tri3":
        return _tri_rule(degree)
    if topo.name == "tet4":
        return _tet_rule(degree)
    raise NotImplementedError(topo.name)
