"""Uniform mesh refinement (the percept URP / STK-adapt touchpoint).

Counterpart of ``trilinos_tpu/fem/refine.py``, a copy (the port imports
nothing of the JAX package).

Reference role: packages/percept (uniform refinement patterns for
STK meshes, e.g. UniformRefinerPattern Quad4_Quad4_4, Hex8_Hex8_8,
Tet4_Tet4_8 — Bey's corner+octahedron split). Here each ``refine_uniform``
pass is a handful of vectorized numpy operations: edge/face/center
midpoints are deduplicated with one ``np.unique`` over sorted vertex
tuples (no per-element loops), children inherit conforming connectivity
by construction, and orientation is verified/corrected by a signed-
volume check so downstream Jacobians stay positive.

Refinement composes with the whole fem stack: ``fe_space`` renumbers
dofs on the refined mesh, assembly/PhysicsBlock/VTK consume the result
unchanged — the standard h-convergence-study driver.
"""

from __future__ import annotations

import numpy as np

from .mesh import Mesh

_TRI_EDGES = [(0, 1), (1, 2), (0, 2)]
# quad4/hex8 connectivity is LEXICOGRAPHIC (tensor-basis order)
_QUAD_EDGES = [(0, 1), (0, 2), (1, 3), (2, 3)]
_TET_EDGES = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]


def _midpoints(coords, conn, tuples):
    """For each element and each vertex tuple, the centroid point.
    Dedup by sorted vertex ids. Returns (ids (ne, nt) into the appended
    array, new_points)."""
    ne = conn.shape[0]
    keys = np.stack([np.sort(conn[:, list(t)], axis=1)
                     for t in tuples], axis=1)      # (ne, nt, len)
    flat = keys.reshape(ne * len(tuples), -1)
    uniq, inv = np.unique(flat, axis=0, return_inverse=True)
    pts = coords[uniq].mean(axis=1)
    return inv.reshape(ne, len(tuples)), pts


def _fix_orientation(coords, conn, dim):
    """Swap two vertices of any child with negative signed volume (the
    simplex measure; tensor cells use their corner simplex)."""
    if dim == 2:
        if conn.shape[1] == 3:
            a = coords[conn[:, 1]] - coords[conn[:, 0]]
            b = coords[conn[:, 2]] - coords[conn[:, 0]]
            bad = (a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]) < 0
            conn[bad] = conn[bad][:, [0, 2, 1]]
        return conn
    if conn.shape[1] == 4:  # tet
        a = coords[conn[:, 1]] - coords[conn[:, 0]]
        b = coords[conn[:, 2]] - coords[conn[:, 0]]
        c = coords[conn[:, 3]] - coords[conn[:, 0]]
        v = np.einsum("ei,ei->e", np.cross(a, b), c)
        bad = v < 0
        conn[bad] = conn[bad][:, [0, 2, 1, 3]]
    return conn


def refine_uniform(mesh: Mesh, times: int = 1) -> Mesh:
    """One (or ``times``) uniform refinement pass(es)."""
    for _ in range(times):
        mesh = _refine_once(mesh)
    return mesh


def _refine_once(mesh: Mesh) -> Mesh:
    name = mesh.topo.name
    coords, conn = mesh.coords, mesh.connect
    n0 = coords.shape[0]

    if name == "tri3":
        eid, epts = _midpoints(coords, conn, _TRI_EDGES)
        e = eid + n0
        v0, v1, v2 = conn.T
        m01, m12, m02 = e.T
        kids = [np.stack(t, 1) for t in [
            (v0, m01, m02), (m01, v1, m12), (m02, m12, v2),
            (m01, m12, m02)]]
        pts = np.vstack([coords, epts])
        return Mesh(mesh.topo, pts,
                    _fix_orientation(pts, np.concatenate(kids), 2))

    if name == "quad4":
        eid, epts = _midpoints(coords, conn, _QUAD_EDGES)
        cid, cpts = _midpoints(coords, conn, [(0, 1, 2, 3)])
        e = eid + n0
        c = cid[:, 0] + n0 + epts.shape[0]
        # lexicographic corners: v00, v01, v10, v11; edge tuples were
        # [(0,1),(0,2),(1,3),(2,3)]: (v00,v01)=x0 edge, (v00,v10)=y0
        # edge, (v01,v11)=y1 edge, (v10,v11)=x1 edge
        v00, v01, v10, v11 = conn.T
        m_x0, m_y0, m_y1, m_x1 = e.T
        kids = [np.stack(t, 1) for t in [
            (v00, m_x0, m_y0, c), (m_x0, v01, c, m_y1),
            (m_y0, c, v10, m_x1), (c, m_y1, m_x1, v11)]]
        pts = np.vstack([coords, epts, cpts])
        return Mesh(mesh.topo, pts, np.concatenate(kids))

    if name == "hex8":
        # lexicographic ids: index = 4a+2b+c over (x,y,z) in {0,1}
        edges = []
        for i in range(8):
            for j in range(i + 1, 8):
                if bin(i ^ j).count("1") == 1:
                    edges.append((i, j))
        # faces = vertex sets with one lattice coordinate fixed
        faces = []
        for bit in (4, 2, 1):
            for val in (0, bit):
                faces.append(tuple(k for k in range(8)
                                   if (k & bit) == val))
        eid, epts = _midpoints(coords, conn, edges)
        fid, fpts = _midpoints(coords, conn, faces)
        cid, cpts = _midpoints(coords, conn, [tuple(range(8))])
        ne = conn.shape[0]
        # assemble the 27 lattice points per element: position (a,b,c)
        # in {0,1,2}^3, lexicographic
        lat = np.zeros((ne, 27), dtype=np.int64)
        off_e = n0
        off_f = n0 + epts.shape[0]
        off_c = off_f + fpts.shape[0]

        def lpos(a, b, c):
            return 9 * a + 3 * b + c

        for a in (0, 2):
            for b in (0, 2):
                for c in (0, 2):
                    lat[:, lpos(a, b, c)] = conn[:, 4 * (a // 2)
                                                 + 2 * (b // 2) + c // 2]
        for k, (i, j) in enumerate(edges):
            pa = np.array([(i >> 2) & 1, (i >> 1) & 1, i & 1]) * 2
            pb = np.array([(j >> 2) & 1, (j >> 1) & 1, j & 1]) * 2
            m = (pa + pb) // 2
            lat[:, lpos(*m)] = eid[:, k] + off_e
        for k, f in enumerate(faces):
            ps = np.array([[(i >> 2) & 1, (i >> 1) & 1, i & 1]
                           for i in f]) * 2
            m = ps.mean(axis=0).astype(int)
            lat[:, lpos(*m)] = fid[:, k] + off_f
        lat[:, lpos(1, 1, 1)] = cid[:, 0] + off_c
        kids = []
        for a in (0, 1):
            for b in (0, 1):
                for c in (0, 1):
                    kid = np.stack([
                        lat[:, lpos(a + da, b + db, c + dc)]
                        for da in (0, 1) for db in (0, 1)
                        for dc in (0, 1)], axis=1)
                    kids.append(kid)
        pts = np.vstack([coords, epts, fpts, cpts])
        return Mesh(mesh.topo, pts, np.concatenate(kids))

    if name == "tet4":
        eid, epts = _midpoints(coords, conn, _TET_EDGES)
        e = eid + n0
        v0, v1, v2, v3 = conn.T
        m01, m02, m03, m12, m13, m23 = e.T
        kids = [np.stack(t, 1) for t in [
            (v0, m01, m02, m03), (m01, v1, m12, m13),
            (m02, m12, v2, m23), (m03, m13, m23, v3),
            # octahedron split along the m02-m13 diagonal (Bey)
            (m01, m02, m03, m13), (m01, m02, m12, m13),
            (m02, m03, m13, m23), (m02, m12, m13, m23)]]
        pts = np.vstack([coords, epts])
        new = _fix_orientation(pts, np.concatenate(kids), 3)
        return Mesh(mesh.topo, pts, new)

    raise ValueError(f"refine_uniform: unsupported topology {name!r}")
