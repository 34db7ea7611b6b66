"""The port's uncoupled smoothed-aggregation AMG against the JAX package's.

Both packages take the same host matrix (Galeri ``laplace2d``,
``laplace3d``, ``recirc2d``, ``elasticity2d`` with its rigid-body modes,
f64). The host set-up must be the reference's bit for bit: the aggregates
(seeded priorities, ``np.maximum.at`` propagation), the tentative
prolongators (piecewise constant and null space), the amalgamated graph,
the smoothed prolongator with the power-method ω, and every level's A_l,
P_l and the coarsest A_c of ``build_hierarchy_host`` (row pointers,
columns exactly, values to 1e-14 relative). The MueLu-style gold counts of
``laplace2d(32, 32)`` hold. Applies of the V- and W-cycle on one vector
and on a block agree to 1e-12 (max|Δ| / max|y|), also through the JAX
package's ``state()`` carried over by
``convert.uncoupled_amg_state_from_jax``; the fine level of a stencil
matrix packs as DIA, coarse levels as ELL, P and Pᵀ as rectangular ELL.
A matrix-free fine operator and the fused Chebyshev smoother on it match
too, and the parameter errors are the reference's. On elasticity2d the
port's null-space hierarchy takes at most half the scalar one's CG
iterations, as the reference's test demands of its own.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from trilinos_tpu import precond as jprec
from trilinos_tpu.galeri import laplace2d as j_laplace2d
from trilinos_tpu.galeri import laplace3d as j_laplace3d
from trilinos_tpu.galeri import recirc2d as j_recirc2d
from trilinos_tpu.galeri.fem import elasticity2d as j_elasticity2d
from trilinos_tpu.galeri.fem import rigid_body_modes as j_rbm
from trilinos_tpu.precond import amg as jamg

from trilinos_tpu_torch import precond as tprec
from trilinos_tpu_torch.convert import uncoupled_amg_state_from_jax
from trilinos_tpu_torch.galeri import laplace3d
from trilinos_tpu_torch.ops import formats as TF
from trilinos_tpu_torch.precond import amg as tamg
from torch_threads import one_thread  # noqa: F401  (autouse)

TOL = 1e-12
MATRICES = {"laplace2d": j_laplace2d(32, 32),
            "laplace3d": j_laplace3d(10, 10, 10),
            "recirc2d": j_recirc2d(16, 12, diff=1e-2),
            "elasticity2d": j_elasticity2d(12, 12, e_mod=1.0)}
NULLSPACE = {"elasticity2d": (j_rbm(12, 12), 2)}


def port_csr(a):
    return TF.CsrHost(a.row_ptr, a.cols, a.vals, a.shape)


def close_csr(got, want, tol=1e-14):
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(got.row_ptr, want.row_ptr)
    np.testing.assert_array_equal(got.cols, want.cols)
    scale = np.abs(want.vals).max() if want.nnz else 1.0
    np.testing.assert_allclose(got.vals, want.vals, rtol=0, atol=tol * scale)


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def vec(npad, n, k=None, seed=1):
    v = np.zeros((npad,) if k is None else (npad, k))
    v[:n] = np.random.default_rng(seed).standard_normal(v[:n].shape)
    return v


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_aggregates_and_tentative_match_jax(name):
    a = MATRICES[name]
    if name in NULLSPACE:
        ns, b = NULLSPACE[name]
        jg, tg = jamg.amalgamate_graph(a, b), tamg.amalgamate_graph(
            port_csr(a), b)
        close_csr(tg, jg, tol=0.0)
        agg = tamg.aggregate(tg)
        np.testing.assert_array_equal(agg, jamg.aggregate(jg))
        p_t, ns_c = tamg.tentative_prolongator_nullspace(agg, b, ns)
        jp_t, jns_c = jamg.tentative_prolongator_nullspace(agg, b, ns)
        np.testing.assert_array_equal(ns_c, jns_c)
        assert np.abs(p_t.to_dense() @ ns_c - ns).max() <= 1e-12
    else:
        agg = tamg.aggregate(port_csr(a))
        np.testing.assert_array_equal(agg, jamg.aggregate(a))
        p_t = tamg.tentative_prolongator(agg)
        jp_t = jamg.tentative_prolongator(agg)
    close_csr(p_t, jp_t, tol=0.0)
    omega = tamg.power_omega(port_csr(a), 4.0 / 3.0)
    close_csr(tamg.smooth_prolongator(port_csr(a), p_t, omega),
              jamg.smooth_prolongator(a, jp_t, 4.0 / 3.0), tol=0.0)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_host_hierarchy_matches_jax(name):
    a = MATRICES[name]
    ns, b = NULLSPACE.get(name, (None, 1))
    args = (10, 16, 2, 4.0 / 3.0)
    levels, a_c = tamg.build_hierarchy_host(port_csr(a), *args,
                                            nullspace=ns, n_equations=b)
    jlevels, ja_c = jamg.build_hierarchy_host(a, *args, nullspace=ns,
                                              n_equations=b)
    assert len(levels) == len(jlevels) >= 2
    for (al, pl), (jal, jpl) in zip(levels, jlevels):
        close_csr(al, jal)
        close_csr(pl, jpl)
    close_csr(a_c, ja_c)
    if name == "laplace2d":
        got = [(al.shape[0], al.vals.size, pl.shape[1])
               for al, pl in levels] + [(a_c.shape[0], a_c.vals.size)]
        assert got == [(1024, 4992, 148), (148, 1446, 10), (10, 74)]


APPLY_CASES = [
    ("laplace3d", {}),
    ("laplace3d", {"cycle type": "W", "smoother: sweeps": 1}),
    ("recirc2d", {"aggregation: type": "uncoupled",
                  "smoother: damping factor": 0.6}),
    ("elasticity2d", {"number of equations": 2, "coarse: max size": 40}),
]


@pytest.mark.parametrize("name,params", APPLY_CASES)
def test_apply_matches_jax(name, params):
    a = MATRICES[name]
    params = dict(params)
    if name in NULLSPACE:
        params["nullspace: vectors"] = NULLSPACE[name][0]
    jm = jprec.SaAmg(a, dict(params)).compute()
    tm = tprec.create("SA-AMG", port_csr(a), dict(params),
                      device="cpu").compute()
    assert tm.n_levels() == jm.n_levels() >= 2
    if name == "laplace3d":
        assert isinstance(tm.levels[0]["a"], TF.DiaMatrix)
    for lvl in tm.levels[1:]:
        assert isinstance(lvl["a"], TF.EllMatrix)
    for lvl, jl in zip(tm.levels, jm.levels):
        assert isinstance(lvl["p"], TF.EllMatrix)
        assert (lvl["p"].n_rows_pad, lvl["pt"].n_rows_pad) == (jl["n_f"],
                                                               jl["n_c"])
    st = uncoupled_amg_state_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.state()), device="cpu")
    npad = tm.levels[0]["n_f"]
    for k in (None, 3):
        r = vec(npad, a.shape[0], k)
        want = np.asarray(jm.apply(jnp.asarray(r)))
        assert rel(tm(torch.from_numpy(r)).numpy(), want) <= TOL
        assert rel(tm.apply_state(st, torch.from_numpy(r)).numpy(),
                   want) <= TOL


@pytest.mark.parametrize("smoother", ["jacobi", "chebyshev"])
def test_matrix_free_fine_level_matches_jax(smoother):
    dims = (8, 8, 8)
    params = {"aggregation: type": "uncoupled", "smoother: type": smoother}
    jm = jprec.SaAmg(j_laplace3d(*dims), {
        **params, "fine: matrix-free operator": j_laplace3d(
            *dims, fmt="stencil")}).compute()
    op = laplace3d(*dims, fmt="stencil")
    tm = tprec.SaAmg(laplace3d(*dims), {
        **params, "fine: matrix-free operator": op}, device="cpu").compute()
    assert tm.levels[0]["a"] is op and tm.fine_op is op
    r = vec(op.n_rows_pad, op.n_rows)
    assert rel(tm(torch.from_numpy(r)).numpy(),
               jm.apply(jnp.asarray(r))) <= TOL


def test_parameter_errors_match_jax():
    op = laplace3d(8, 8, 8, fmt="stencil")
    with pytest.raises(TypeError, match="CsrHost"):
        tprec.SaAmg(op, {"aggregation: type": "uncoupled"},
                    device="cpu").compute()
    with pytest.raises(ValueError, match="nullspace"):
        tprec.SaAmg(op, {"aggregation: type": "structured",
                         "nullspace: vectors": np.ones((512, 1))},
                    device="cpu").compute()
    with pytest.raises(ValueError, match="chebyshev"):
        tprec.SaAmg(laplace3d(8, 8, 8), {"smoother: type": "chebyshev"},
                    device="cpu").compute()
    with pytest.raises(ValueError, match="shape"):
        tprec.SaAmg(laplace3d(8, 8, 8), {
            "fine: matrix-free operator": laplace3d(4, 4, 4, fmt="stencil")},
            device="cpu").compute()
    # a problem no larger than "coarse: max size" is one dense solve
    small = tprec.SaAmg(laplace3d(3, 3, 3), device="cpu").compute()
    assert small.n_levels() == 1
    r = torch.from_numpy(vec(32, 27))
    np.testing.assert_allclose(small(r).numpy()[:27], np.linalg.solve(
        laplace3d(3, 3, 3).to_dense(), r.numpy()[:27]), rtol=1e-12)


def test_null_space_beats_scalar_aggregation_on_elasticity():
    """The port's own CG on elasticity2d 24² (f64, rtol 1e-8): the
    rigid-body-mode hierarchy takes at most 20 iterations and at most half
    the scalar hierarchy's (the reference's test measured 12 and 32)."""
    from trilinos_tpu_torch.galeri import elasticity2d, rigid_body_modes
    from trilinos_tpu_torch.ops import spmv
    from trilinos_tpu_torch.solvers import cg

    a = elasticity2d(24, 24, e_mod=1.0)
    iters = {}
    for label, params in (("ns", {"nullspace: vectors": rigid_body_modes(
            24, 24), "number of equations": 2}), ("scalar", {})):
        m = tprec.SaAmg(a, params, device="cpu").compute()
        op = m.fine_op
        b = torch.from_numpy(vec(op.n_rows_pad, a.shape[0], seed=0))
        res = cg(lambda v: spmv(op, v), b, prec=m, rtol=1e-8, maxiter=200)
        assert bool(res.converged)
        x = res.x.numpy()[:a.shape[0]]
        assert (np.linalg.norm(b.numpy()[:a.shape[0]] - a.to_dense() @ x)
                / np.linalg.norm(b.numpy()[:a.shape[0]])) <= 1.1e-8
        iters[label] = int(res.iters)
    assert iters["ns"] <= 20 and 2 * iters["ns"] <= iters["scalar"], iters
