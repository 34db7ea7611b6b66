"""HGRAD Lagrange bases on reference cells (the Intrepid2 Basis analogue).

Counterpart of ``trilinos_tpu/fem/basis.py``, a copy (the port imports
nothing of the JAX package).

Reference: packages/intrepid2/src/Discretization/Basis —
Intrepid2_HGRAD_{TRI,QUAD,TET,HEX}_C1/C2/In_FEM.hpp (fixed low-order
closed forms + arbitrary-degree nodal families) and
Intrepid2_DerivedBasis_HGRAD_QUAD/HEX.hpp (tensor products of the 1-D
basis — the construction used here for ALL tensor cells, any degree).

Each basis is a host-numpy object: ``values(points)`` -> (Q, n) and
``grads(points)`` -> (Q, n, dim) tables. Dof ordering is the basis's own
``dof_coords`` ordering (lexicographic for tensor cells; vertices then
edge nodes for simplices) — mesh generators and assembly key off
``dof_coords``, so no external node-ordering convention leaks in.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np

from .cells import CellTopology


def lagrange_nodes_1d(degree: int) -> np.ndarray:
    """Gauss-Lobatto points on [-1, 1] (endpoints + roots of P'_degree) —
    the well-conditioned nodal set for high-degree Lagrange bases."""
    if degree == 1:
        return np.array([-1.0, 1.0])
    pn = np.zeros(degree + 1)
    pn[-1] = 1.0
    interior = np.polynomial.legendre.Legendre(pn).deriv().roots()
    return np.concatenate([[-1.0], np.sort(interior), [1.0]])


def _lagrange_1d_tables(nodes: np.ndarray, x: np.ndarray):
    """Values and derivatives of the 1-D Lagrange basis at x, by the
    product formula (exact, stable for the Lobatto nodes used here)."""
    n = len(nodes)
    x = np.asarray(x, dtype=np.float64)
    vals = np.ones((x.size, n))
    grads = np.zeros((x.size, n))
    for i in range(n):
        others = [j for j in range(n) if j != i]
        denom = np.prod(nodes[i] - nodes[others])
        diffs = x[:, None] - nodes[others][None, :]  # (Q, n-1)
        vals[:, i] = np.prod(diffs, axis=1) / denom
        # d/dx prod = sum_k prod_{j!=k}
        for k in range(n - 1):
            mask = np.ones(n - 1, bool)
            mask[k] = False
            grads[:, i] += np.prod(diffs[:, mask], axis=1) / denom
    return vals, grads


@dataclasses.dataclass(frozen=True)
class Basis:
    topology: CellTopology
    degree: int
    dof_coords: np.ndarray  # (n, dim) nodal points in the reference cell
    _eval: callable = dataclasses.field(repr=False)

    @property
    def n_dofs(self) -> int:
        return self.dof_coords.shape[0]

    def values(self, points: np.ndarray) -> np.ndarray:
        return self._eval(np.atleast_2d(points))[0]

    def grads(self, points: np.ndarray) -> np.ndarray:
        return self._eval(np.atleast_2d(points))[1]


def _tensor_basis(topo: CellTopology, degree: int) -> Basis:
    d = topo.dim
    nodes1 = lagrange_nodes_1d(degree)
    combos = list(itertools.product(range(degree + 1), repeat=d))
    dof_coords = np.array([[nodes1[c[k]] for k in range(d)]
                           for c in combos])

    def ev(points):
        pts = np.asarray(points, dtype=np.float64)
        tabs = [_lagrange_1d_tables(nodes1, pts[:, k]) for k in range(d)]
        q = pts.shape[0]
        vals = np.ones((q, len(combos)))
        grads = np.zeros((q, len(combos), d))
        for i, c in enumerate(combos):
            for k in range(d):
                vals[:, i] *= tabs[k][0][:, c[k]]
            for gdim in range(d):
                g = np.ones(q)
                for k in range(d):
                    g *= (tabs[k][1] if k == gdim else tabs[k][0])[:, c[k]]
                grads[:, i, gdim] = g
        return vals, grads

    return Basis(topo, degree, dof_coords, ev)


def _tri_basis(topo: CellTopology, degree: int) -> Basis:
    if degree == 1:
        dof_coords = topo.vertices

        def ev(points):
            x, y = points[:, 0], points[:, 1]
            vals = np.stack([1 - x - y, x, y], axis=1)
            g = np.array([[-1.0, -1], [1, 0], [0, 1]])
            return vals, np.broadcast_to(g, (len(x), 3, 2)).copy()
    elif degree == 2:
        v = topo.vertices
        dof_coords = np.vstack([v, (v[[0, 1, 0]] + v[[1, 2, 2]]) / 2.0])

        def ev(points):
            x, y = points[:, 0], points[:, 1]
            lam = np.stack([1 - x - y, x, y], axis=1)       # (Q, 3)
            dlam = np.array([[-1.0, -1], [1, 0], [0, 1]])   # (3, 2)
            vals = np.concatenate([
                lam * (2 * lam - 1),
                4 * lam[:, [0, 1, 0]] * lam[:, [1, 2, 2]]], axis=1)
            grads = np.empty((len(x), 6, 2))
            for a in range(3):
                grads[:, a] = (4 * lam[:, a] - 1)[:, None] * dlam[a]
            for e, (a, b) in enumerate([(0, 1), (1, 2), (0, 2)]):
                grads[:, 3 + e] = 4 * (lam[:, a][:, None] * dlam[b]
                                       + lam[:, b][:, None] * dlam[a])
            return vals, grads
    else:
        raise NotImplementedError("tri basis degree <= 2")
    return Basis(topo, degree, dof_coords, ev)


def _tet_basis(topo: CellTopology, degree: int) -> Basis:
    if degree != 1:
        raise NotImplementedError("tet basis degree 1 only")

    def ev(points):
        x, y, z = points[:, 0], points[:, 1], points[:, 2]
        vals = np.stack([1 - x - y - z, x, y, z], axis=1)
        g = np.array([[-1.0, -1, -1], [1, 0, 0], [0, 1, 0], [0, 0, 1]])
        return vals, np.broadcast_to(g, (len(x), 4, 3)).copy()

    return Basis(topo, 1, topo.vertices, ev)


def hgrad_basis(topo: CellTopology, degree: int = 1) -> Basis:
    """Nodal HGRAD basis of the given degree on a reference cell."""
    if topo.family == "tensor":
        return _tensor_basis(topo, degree)
    if topo.name == "tri3":
        return _tri_basis(topo, degree)
    if topo.name == "tet4":
        return _tet_basis(topo, degree)
    raise NotImplementedError(topo.name)
