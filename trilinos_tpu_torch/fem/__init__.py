"""FE discretization layer (the Intrepid2 + Shards + pamgen-lite analogue).

Counterpart of ``trilinos_tpu/fem``. Every module but ``phalanx.py`` is a
host numpy copy (the port imports nothing of the JAX package);
``phalanx.py`` (Phalanx's evaluator DAG and Panzer's physics block) builds
its workset on the host and assembles residuals with torch on the device.

Reference: packages/intrepid2/src — Discretization/Basis (HGRAD Lagrange
bases per cell topology, Intrepid2_HGRAD_*_FEM.hpp), Discretization/
Integration (cubature factories), Cell/Intrepid2_CellTools.hpp (Jacobians,
ref↔phys maps, HGRAD transforms); packages/shards/src/Shards_CellTopology
.hpp (topology descriptions); packages/pamgen (inline structured mesh
generation); packages/moertel (mortar coupling); packages/percept
(uniform refinement). Assembly feeds ``ops.fe``'s Export-sum, and
``poisson_dirichlet(..., elements=True)`` its matrix-free
``fe_apply_local``.

Bases are closed-form numpy tables evaluated once at the cubature points
of a reference cell; per-element work (Jacobians, transforms, local
stiffness) is one batched einsum over all elements, with no per-element
loop.
"""

from .cells import CellTopology, HEX8, LINE2, QUAD4, TET4, TRI3
from .basis import hgrad_basis, lagrange_nodes_1d
from .cubature import cubature
from .cell_tools import (hgrad_transform_grad, jacobian, jacobian_det,
                         jacobian_inv, map_to_physical)
from .mesh import (Mesh, structured_hex_mesh, structured_quad_mesh,
                   structured_tet_mesh, structured_tri_mesh)
from .assembly import (load_vector, mass_matrix, poisson_dirichlet,
                       stiffness_matrix)
from .phalanx import Evaluator, FieldManager, PhysicsBlock
from .mortar import (interface_dofs, mortar_glue, mortar_projection_1d,
                     mortar_saddle)
from .refine import refine_uniform

__all__ = [
    "CellTopology", "LINE2", "TRI3", "QUAD4", "TET4", "HEX8",
    "hgrad_basis", "lagrange_nodes_1d", "cubature", "jacobian",
    "jacobian_det", "jacobian_inv", "map_to_physical",
    "hgrad_transform_grad", "Mesh", "structured_quad_mesh",
    "structured_tri_mesh", "structured_hex_mesh", "structured_tet_mesh",
    "stiffness_matrix", "mass_matrix", "load_vector", "poisson_dirichlet",
    "Evaluator", "FieldManager", "PhysicsBlock",
    "mortar_projection_1d", "mortar_glue", "mortar_saddle",
    "interface_dofs", "refine_uniform",
]
