"""Mortar coupling of nonconforming interfaces (the Moertel analogue).

Counterpart of ``trilinos_tpu/fem/mortar.py``, a copy (the port imports
nothing of the JAX package).

Reference: packages/moertel/src/mortar — MOERTEL::Interface (two-sided
interface with master/mortar and slave sides), MOERTEL::Integrator
(segment-based overlap integration of the slave trace space against
both sides), mrtr_manager.cpp (assembling the D (slave x slave) and
M (slave x master) coupling matrices and producing either the
saddle-point system or the condensed positive-definite system). Dual
(biorthogonal) Lagrange multiplier shape functions follow Wohlmuth —
MOERTEL's ``lmshape_lineardual`` — which make D diagonal so the slave
side condenses by a diagonal solve.

TPU-first form: interfaces here are 1-D polylines between 2-D meshes
(the P1 trace case). The overlap segmentation (merge both grids'
breakpoints), 2-point Gauss integration, and hat/dual-shape evaluation
are fully vectorized host numpy — the output is small dense D, M and
the projection P = D^-1 M, plus sparse host constraint algebra
(C^T K C through the framework's SpGEMM) producing a condensed system
that runs through any device solver unchanged. The saddle-point
(Lagrange multiplier) form is also exposed for the block-2x2
preconditioners.
"""

from __future__ import annotations

import numpy as np

from ..ops.formats import CsrHost
from ..ops.matrix_ops import spgemm

_GAUSS2 = (np.array([-1.0, 1.0]) / np.sqrt(3.0) + 1.0) / 2.0  # on [0,1]


def _hat_eval(grid, x):
    """P1 hat functions of ``grid`` at points ``x``: (len(x), len(grid))
    dense (interfaces are small)."""
    grid = np.asarray(grid, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    k = np.clip(np.searchsorted(grid, x, side="right") - 1, 0,
                len(grid) - 2)
    t = (x - grid[k]) / (grid[k + 1] - grid[k])
    out = np.zeros((len(x), len(grid)))
    out[np.arange(len(x)), k] = 1.0 - t
    out[np.arange(len(x)), k + 1] = t
    return out


def mortar_projection_1d(x_slave, x_master, kind: str = "dual",
                         end_modification: bool = True):
    """Mortar integrals on a shared 1-D interface with P1 traces on two
    (generally nonmatching) grids. Returns (D, M, P):

      D[i,j] = int lambda_i phi^s_j,  M[i,k] = int lambda_i phi^m_k,
      P (n_slave x n_master) maps master interface values to slave ones.

    ``kind``: "dual" — biorthogonal multipliers (D diagonal, MOERTEL's
    lmshape_lineardual); "standard" — multipliers = slave hats (D is the
    slave interface mass matrix).

    ``end_modification`` applies the crosspoint treatment (the
    reference's boundary modification of the LM space): the interface
    endpoints — shared by both grids and typically lying on a Dirichlet
    boundary — are tied by direct identification, the endpoint
    multipliers are removed, and (standard kind) the adjacent
    multipliers are constant-extended over the end elements. Without it
    the standard kind's dense D^-1 smears endpoint flux jumps across
    the whole interface and the mortar patch test fails on interfaces
    that touch the outer boundary."""
    xs = np.asarray(x_slave, dtype=np.float64)
    xm = np.asarray(x_master, dtype=np.float64)
    if xs.ndim != 1 or xm.ndim != 1 or len(xs) < 2 or len(xm) < 2:
        raise ValueError("interface grids must be 1-D with >= 2 nodes")
    if not (np.all(np.diff(xs) > 0) and np.all(np.diff(xm) > 0)):
        raise ValueError("interface grids must be strictly increasing")
    tol = 1e-9 * max(xs[-1] - xs[0], 1.0)
    if abs(xs[0] - xm[0]) > tol or abs(xs[-1] - xm[-1]) > tol:
        raise ValueError("slave and master interfaces must span the "
                         "same segment")

    # overlap segmentation: breakpoints of both grids
    brk = np.unique(np.concatenate([xs, xm]))
    a, b = brk[:-1], brk[1:]
    # 2-point Gauss on every segment (exact for the P1 x P1 products)
    xq = (a[:, None] + (b - a)[:, None] * _GAUSS2[None, :]).ravel()
    wq = np.repeat(0.5 * (b - a), 2)

    phi_s = _hat_eval(xs, xq)              # (nq, ns)
    phi_m = _hat_eval(xm, xq)              # (nq, nm)
    if kind == "standard":
        lam = phi_s
    elif kind == "dual":
        # elementwise duals: on the slave element containing x with
        # local hats (N1, N2), psi = (2N1 - N2, 2N2 - N1); assembled by
        # the same nodal connectivity as the hats.
        k = np.clip(np.searchsorted(xs, xq, side="right") - 1, 0,
                    len(xs) - 2)
        n2 = phi_s[np.arange(len(xq)), k + 1]
        n1 = 1.0 - n2
        lam = np.zeros_like(phi_s)
        lam[np.arange(len(xq)), k] = 2.0 * n1 - n2
        lam[np.arange(len(xq)), k + 1] = 2.0 * n2 - n1
    else:
        raise ValueError(f"unknown multiplier kind {kind!r}")

    if end_modification:
        ns, nm = len(xs), len(xm)
        if kind == "standard" and ns > 3:
            # constant-extend the multipliers adjacent to the endpoints
            lam = lam.copy()
            lam[:, 1] += lam[:, 0]
            lam[:, ns - 2] += lam[:, ns - 1]
        d = np.einsum("q,qi,qj->ij", wq, lam[:, 1:-1], phi_s)
        m = np.einsum("q,qi,qk->ik", wq, lam[:, 1:-1], phi_m)
        p = np.zeros((ns, nm))
        p[0, 0] = 1.0            # crosspoints: direct identification
        p[-1, -1] = 1.0
        if ns > 2:
            # D_int u_int = M u_m - D[:,0] u_m[0] - D[:,-1] u_m[-1]
            rhs = m.copy()
            rhs[:, 0] -= d[:, 0]
            rhs[:, -1] -= d[:, -1]
            if kind == "dual":
                p[1:-1] = rhs / np.diag(d[:, 1:-1])[:, None]
            else:
                p[1:-1] = np.linalg.solve(d[:, 1:-1], rhs)
        return d, m, p

    d = np.einsum("q,qi,qj->ij", wq, lam, phi_s)
    m = np.einsum("q,qi,qk->ik", wq, lam, phi_m)
    if kind == "dual":
        p = m / np.diag(d)[:, None]
    else:
        p = np.linalg.solve(d, m)
    return d, m, p


def block_diag(k_a: CsrHost, k_b: CsrHost) -> CsrHost:
    """blockdiag(K_a, K_b) as one CsrHost."""
    na, nb = k_a.shape[0], k_b.shape[0]
    rows_a = np.repeat(np.arange(na), np.diff(k_a.row_ptr))
    rows_b = np.repeat(np.arange(nb), np.diff(k_b.row_ptr))
    return CsrHost.from_coo(
        np.concatenate([rows_a, rows_b + na]),
        np.concatenate([k_a.cols, k_b.cols + k_a.shape[1]]),
        np.concatenate([k_a.vals, k_b.vals]),
        (na + nb, k_a.shape[1] + k_b.shape[1]))


def mortar_constraint(n_a: int, n_b: int, slave_dofs, master_dofs, p):
    """Constraint matrix C with u_full = C u_reduced for the coupled
    pair: full numbering = [A dofs] ++ [B dofs], reduced numbering =
    [A dofs] ++ [B dofs minus the slave interface]; slave rows carry
    P onto the A-side master interface dofs. Returns (C CsrHost,
    reduced_of_full index map with -1 on eliminated dofs)."""
    slave = np.asarray(slave_dofs, dtype=np.int64)
    master = np.asarray(master_dofs, dtype=np.int64)
    p = np.asarray(p, dtype=np.float64)
    if p.shape != (len(slave), len(master)):
        raise ValueError("P shape does not match interface dof counts")
    keep_b = np.setdiff1d(np.arange(n_b), slave)
    red_of_full = np.full(n_a + n_b, -1, dtype=np.int64)
    red_of_full[:n_a] = np.arange(n_a)
    red_of_full[n_a + keep_b] = n_a + np.arange(len(keep_b))
    n_red = n_a + len(keep_b)

    rows = [np.arange(n_a), n_a + keep_b]
    cols = [np.arange(n_a), red_of_full[n_a + keep_b]]
    vals = [np.ones(n_a), np.ones(len(keep_b))]
    # slave rows: u_slave = P u_master (master dofs live on the A side)
    sr, sc = np.nonzero(np.abs(p) > 1e-14)
    rows.append(n_a + slave[sr])
    cols.append(red_of_full[master[sc]])
    vals.append(p[sr, sc])
    c = CsrHost.from_coo(np.concatenate(rows), np.concatenate(cols),
                         np.concatenate(vals), (n_a + n_b, n_red))
    return c, red_of_full


def mortar_glue(k_a: CsrHost, k_b: CsrHost, f_a, f_b, slave_dofs,
                master_dofs, p):
    """Condensed mortar coupling (mrtr_manager.cpp's spd path):
    K_red = C^T blockdiag(K_a, K_b) C,  f_red = C^T [f_a; f_b].
    ``slave_dofs`` index into the B mesh, ``master_dofs`` into the A
    mesh, ``p`` maps master to slave interface values. Returns
    (K_red, f_red, C, red_of_full)."""
    c, red_of_full = mortar_constraint(
        k_a.shape[0], k_b.shape[0], slave_dofs, master_dofs, p)
    k_full = block_diag(k_a, k_b)
    ct = c.transpose()
    k_red = spgemm(spgemm(ct, k_full), c)
    f_red = ct.matvec_host(np.concatenate([np.asarray(f_a, np.float64),
                                           np.asarray(f_b, np.float64)]))
    return k_red, f_red, c, red_of_full


def mortar_saddle(k_a: CsrHost, k_b: CsrHost, slave_dofs, master_dofs,
                  d, m):
    """Lagrange-multiplier (saddle-point) form: returns (K_full, B)
    with the constraint  B u = D u_slave - M u_master = 0, for the
    block-2x2 solver/preconditioner path."""
    slave = np.asarray(slave_dofs, dtype=np.int64)
    master = np.asarray(master_dofs, dtype=np.int64)
    n_a = k_a.shape[0]
    d = np.asarray(d)
    m = np.asarray(m)
    rows_d, cols_d = np.nonzero(np.abs(d) > 1e-14)
    rows_m, cols_m = np.nonzero(np.abs(m) > 1e-14)
    b = CsrHost.from_coo(
        np.concatenate([rows_d, rows_m]),
        np.concatenate([n_a + slave[cols_d], master[cols_m]]),
        np.concatenate([d[rows_d, cols_d], -m[rows_m, cols_m]]),
        (d.shape[0], n_a + k_b.shape[0]))
    return block_diag(k_a, k_b), b


def interface_dofs(dof_coords, axis: int, value: float, tol=1e-9):
    """Dof ids lying on the hyperplane coord[axis] == value, sorted
    along the interface (by the other coordinate(s)). Returns
    (ids, interface_coordinates_along_the_line) for the 2-D case."""
    xy = np.asarray(dof_coords)
    on = np.abs(xy[:, axis] - value) < tol
    ids = np.nonzero(on)[0]
    other = 1 - axis if xy.shape[1] == 2 else \
        [d for d in range(xy.shape[1]) if d != axis][0]
    order = np.argsort(xy[ids, other])
    ids = ids[order]
    return ids, xy[ids, other]
