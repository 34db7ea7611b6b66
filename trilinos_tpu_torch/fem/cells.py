"""Reference cell topologies (the Shards analogue).

Counterpart of ``trilinos_tpu/fem/cells.py``, a copy (the port imports
nothing of the JAX package).

Reference: packages/shards/src/Shards_CellTopology.hpp and
Shards_BasicTopologies.hpp — here reduced to what discretization needs:
dimension, vertex coordinates of the reference cell, and the cell family
("simplex" or "tensor") that selects basis/cubature construction.

Reference-domain conventions (matching Intrepid2's):
  line  [-1, 1];  quad/hex [-1, 1]^d;
  tri   {(x,y): x,y >= 0, x+y <= 1};  tet the unit 3-simplex.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CellTopology:
    name: str
    dim: int
    family: str          # "simplex" | "tensor"
    vertices: np.ndarray  # (n_vertices, dim)

    @property
    def n_vertices(self) -> int:
        return self.vertices.shape[0]


LINE2 = CellTopology("line2", 1, "tensor",
                     np.array([[-1.0], [1.0]]))

TRI3 = CellTopology("tri3", 2, "simplex",
                    np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]]))

# counterclockwise, matching Intrepid2_HGRAD_QUAD_C1_FEM node order
QUAD4 = CellTopology("quad4", 2, "tensor",
                     np.array([[-1.0, -1.0], [1.0, -1.0],
                               [1.0, 1.0], [-1.0, 1.0]]))

TET4 = CellTopology("tet4", 3, "simplex",
                    np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0],
                              [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]))

HEX8 = CellTopology("hex8", 3, "tensor",
                    np.array([[-1.0, -1.0, -1.0], [1.0, -1.0, -1.0],
                              [1.0, 1.0, -1.0], [-1.0, 1.0, -1.0],
                              [-1.0, -1.0, 1.0], [1.0, -1.0, 1.0],
                              [1.0, 1.0, 1.0], [-1.0, 1.0, 1.0]]))

BY_NAME = {c.name: c for c in (LINE2, TRI3, QUAD4, TET4, HEX8)}
