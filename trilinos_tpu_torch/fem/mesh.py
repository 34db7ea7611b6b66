"""Inline structured meshes + nodal FE-space construction (pamgen-lite).

Counterpart of ``trilinos_tpu/fem/mesh.py``, a copy (the port imports
nothing of the JAX package); ``fe_space`` finds the same numbering by
another sort.

Reference: packages/pamgen/src/create_inline_mesh.h (inline structured
mesh generation) and the FE-space/dof-manager role that panzer/fei play
above Intrepid2 — reduced to the structured unit-domain generators the
solver stack's tests and Galeri-style problems need.

``fe_space`` builds a global dof numbering for ANY nodal basis degree by
placing the basis's reference dof points through the geometry map and
deduplicating physical positions — one vectorized pass, no per-element
loops, valid on conforming meshes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .basis import Basis, hgrad_basis
from .cells import HEX8, QUAD4, TET4, TRI3, CellTopology
from .cell_tools import map_to_physical


@dataclasses.dataclass(frozen=True)
class Mesh:
    topo: CellTopology
    coords: np.ndarray   # (n_vertices, dim) physical vertex coords
    connect: np.ndarray  # (ne, n_geo) vertex ids, geometry-basis order

    @property
    def cell_coords(self) -> np.ndarray:
        return self.coords[self.connect]  # (ne, n_geo, dim)


def _grid(ns):
    axes = [np.linspace(0.0, 1.0, n + 1) for n in ns]
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.stack([m.ravel() for m in mesh], axis=1)


def _vid(idx, ns):
    """Lexicographic vertex id (first axis slowest — numpy ravel order)."""
    out = idx[0]
    for k in range(1, len(ns)):
        out = out * (ns[k] + 1) + idx[k]
    return out


def structured_quad_mesh(nx: int, ny: int) -> Mesh:
    coords = _grid((nx, ny))
    i, j = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    i, j = i.ravel(), j.ravel()
    # geometry-basis (lexicographic tensor) dof order:
    # (-1,-1), (-1,+1), (+1,-1), (+1,+1)
    conn = np.stack([_vid((i, j), (nx, ny)),
                     _vid((i, j + 1), (nx, ny)),
                     _vid((i + 1, j), (nx, ny)),
                     _vid((i + 1, j + 1), (nx, ny))], axis=1)
    return Mesh(QUAD4, coords, conn)


def structured_tri_mesh(nx: int, ny: int) -> Mesh:
    coords = _grid((nx, ny))
    i, j = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    i, j = i.ravel(), j.ravel()
    v00 = _vid((i, j), (nx, ny))
    v01 = _vid((i, j + 1), (nx, ny))
    v10 = _vid((i + 1, j), (nx, ny))
    v11 = _vid((i + 1, j + 1), (nx, ny))
    conn = np.concatenate([np.stack([v00, v10, v11], axis=1),
                           np.stack([v00, v11, v01], axis=1)])
    return Mesh(TRI3, coords, conn)


def structured_hex_mesh(nx: int, ny: int, nz: int) -> Mesh:
    ns = (nx, ny, nz)
    coords = _grid(ns)
    i, j, k = np.meshgrid(*[np.arange(n) for n in ns], indexing="ij")
    i, j, k = i.ravel(), j.ravel(), k.ravel()
    conn = np.stack([_vid((i + a, j + b, k + c), ns)
                     for a in (0, 1) for b in (0, 1) for c in (0, 1)],
                    axis=1)
    # geometry dof order is lexicographic in (x, y, z) — reorder the
    # (a,b,c) loop accordingly: combos (0,0,0),(0,0,1),(0,1,0)... match
    # itertools.product over (x,y,z), which the stack above already is
    return Mesh(HEX8, coords, conn)


def structured_tet_mesh(nx: int, ny: int, nz: int) -> Mesh:
    """Each hex split into 6 tets (Kuhn simplices around the main
    diagonal — a conforming decomposition)."""
    hexm = structured_hex_mesh(nx, ny, nz)
    h = hexm.connect  # columns: (a,b,c) lexicographic over (x,y,z)
    c000, c001, c010, c011, c100, c101, c110, c111 = h.T
    tets = [
        (c000, c100, c110, c111), (c000, c110, c010, c111),
        (c000, c010, c011, c111), (c000, c011, c001, c111),
        (c000, c001, c101, c111), (c000, c101, c100, c111),
    ]
    conn = np.concatenate([np.stack(t, axis=1) for t in tets])
    return Mesh(TET4, hexm.coords, conn)


def fe_space(mesh: Mesh, basis: Basis):
    """Global dof numbering for a nodal basis on a conforming mesh.

    Returns (dof_connect (ne, n_dofs), dof_coords (n_global, dim)):
    reference dof points are pushed through the geometry map and
    deduplicated by (rounded) physical position. The numbering is
    ``np.unique(..., axis=0)``'s (rows in lexicographic order), found by
    one ``np.lexsort`` over the coordinates, which sorts plain float
    columns instead of structured rows (ten times faster at 48³ hexes).
    """
    geom = hgrad_basis(mesh.topo, 1)
    phys = map_to_physical(mesh.cell_coords, basis.dof_coords, geom)
    ne, nd, dim = phys.shape
    flat = np.round(phys.reshape(-1, dim), 9)
    order = np.lexsort(flat.T[::-1])
    srt = flat[order]
    first = np.empty(len(srt), dtype=bool)
    first[:1] = True
    np.any(srt[1:] != srt[:-1], axis=1, out=first[1:])
    inv = np.empty(len(flat), dtype=np.int64)
    inv[order] = np.cumsum(first) - 1
    return inv.reshape(ne, nd), srt[first]
