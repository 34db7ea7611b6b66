"""Port parity: block-structured null-space AMG against the JAX package.

Twins of ``tests/test_block_amg.py``. Both packages build the hierarchy
from their own copies of the Galeri elasticity problems and host set-up;
the port applies it with plain PyTorch on the CPU. In f64 the transfers
must equal the host Galerkin prolongator to 1e-12, AMG-PCG must take the
JAX package's iteration count and reach its x to 1e-10, and the JAX
state carried into the port must give the JAX V-cycle to 1e-12.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from trilinos_tpu.galeri import fem as jfem
from trilinos_tpu.ops import matvec as jmv
from trilinos_tpu.precond.block_amg import BlockStructuredAmg as JBlockAmg
from trilinos_tpu.solvers import cg as j_cg

from trilinos_tpu_torch.convert import block_amg_state_from_jax
from trilinos_tpu_torch.galeri import (elasticity2d, elasticity3d,
                                       rigid_body_modes)
from trilinos_tpu_torch.ops import BdiaMatrix, bdia_spmv, spmv
from trilinos_tpu_torch.precond import BlockStructuredAmg
from trilinos_tpu_torch.precond.amg import (smooth_prolongator,
                                            structured_block,
                                            tentative_prolongator_nullspace)
from trilinos_tpu_torch.precond.block_amg import (_gershgorin_dinv_a,
                                                  _structured_node_agg)
from trilinos_tpu_torch.solvers import cg
from torch_threads import one_thread  # noqa: F401  (autouse)


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def build(dims, params=None, dtype=None):
    """(port hierarchy, JAX hierarchy, host CSR) on the same problem."""
    gen, jgen = ((elasticity2d, jfem.elasticity2d) if len(dims) == 2
                 else (elasticity3d, jfem.elasticity3d))
    a = gen(*dims, e_mod=1.0)
    p = dict(params or {})
    m = BlockStructuredAmg(a, dict(p, dtype=dtype[0]) if dtype else p,
                           node_dims=dims, nullspace=rigid_body_modes(*dims),
                           n_equations=len(dims), device="cpu").compute()
    jm = JBlockAmg(jgen(*dims, e_mod=1.0),
                   dict(p, dtype=dtype[1]) if dtype else p, node_dims=dims,
                   nullspace=jfem.rigid_body_modes(*dims),
                   n_equations=len(dims)).compute()
    return m, jm, a


def rhs(m, n, seed, dtype=np.float64):
    b = np.zeros(m.levels[0]["n_f"], dtype)
    b[:n] = np.random.default_rng(seed).standard_normal(n)
    return b


def test_prolong_matches_host_smoothed_p():
    nx = ny = 8
    a = elasticity2d(nx, ny, e_mod=1.0)
    ns = rigid_body_modes(nx, ny)
    m = BlockStructuredAmg(a, {"coarse: max size": 8}, node_dims=(nx, ny),
                           nullspace=ns, n_equations=2,
                           device="cpu").compute()
    agg = _structured_node_agg((nx, ny, 1), structured_block((nx, ny, 1)))
    p_t, _ = tentative_prolongator_nullspace(agg, 2, ns)
    om = 4.0 / 3.0 / _gershgorin_dinv_a(a)
    p_s = smooth_prolongator(a, p_t, om).to_dense()
    for lvl in m.levels:
        assert lvl["omega_t"] == (om if lvl is m.levels[0] else lvl["omega_t"])
    lvl = m.levels[0]
    rng = np.random.default_rng(1)
    ec = np.zeros(lvl["n_c"])
    ec[:p_s.shape[1]] = rng.standard_normal(p_s.shape[1])
    dev_p = lvl["prolong"](torch.from_numpy(ec)).numpy()
    np.testing.assert_allclose(dev_p[:p_s.shape[0]], p_s @ ec[:p_s.shape[1]],
                               rtol=1e-12, atol=1e-14)
    assert not dev_p[p_s.shape[0]:].any()
    rf = np.zeros(lvl["n_f"])
    rf[:p_s.shape[0]] = rng.standard_normal(p_s.shape[0])
    dev_r = lvl["restrict"](torch.from_numpy(rf)).numpy()
    np.testing.assert_allclose(dev_r[:p_s.shape[1]], p_s.T @ rf[:p_s.shape[0]],
                               rtol=1e-12, atol=1e-14)
    # 3-D, b = 3 → k = 6: the transfers of the JAX package's hierarchy
    m3, jm3, _ = build((8, 8, 4), {"coarse: max size": 40})
    for lv, jlv in zip(m3.levels, jm3.levels, strict=True):
        e = np.random.default_rng(2).standard_normal(lv["n_c"])
        r = np.random.default_rng(3).standard_normal(lv["n_f"])
        assert rel(lv["prolong"](torch.from_numpy(e)).numpy(),
                   jlv["prolong"](jnp.asarray(e))) <= 1e-12
        assert rel(lv["restrict"](torch.from_numpy(r)).numpy(),
                   jlv["restrict"](jnp.asarray(r))) <= 1e-12


def test_amg_pcg_matches_jax():
    """2-D, 24×24 nodes. The 3-D twin (8³ nodes, one b = 3 → k = 6 level)
    is ``test_torch_entry.py``'s ``elasticity_entry`` against the JAX
    solve on the same hierarchy, so the suite compiles that JAX solve
    once."""
    dims, seed = (24, 24), 0
    m, jm, a = build(dims)
    assert len(m.levels) == len(jm.levels) >= 1
    for lv, jlv in zip(m.levels, jm.levels):
        assert isinstance(lv["a"], BdiaMatrix)
        assert lv["a"].offsets == jlv["a"].offsets
        assert (lv["n_f"], lv["n_c"], lv["bk"]) == (jlv["n_f"], jlv["n_c"],
                                                   jlv["bk"])
        assert lv["omega_s"] == jlv["omega_s"]
        np.testing.assert_allclose(lv["q"].numpy(), np.asarray(jlv["q"]),
                                   rtol=0, atol=1e-15)
    b = rhs(m, a.shape[0], seed)
    res = cg(lambda v: spmv(m.fine_op, v), torch.from_numpy(b), prec=m,
             rtol=1e-8, maxiter=100)
    dev = jm.levels[0]["a"]
    jres = j_cg(lambda v: jmv.spmv(dev, v), jnp.asarray(b), prec=jm,
                rtol=1e-8, maxiter=100)
    assert bool(res.converged) and bool(jres.converged)
    assert res.iters == int(jres.iters) <= 15
    assert rel(res.x.numpy(), jres.x) <= 1e-10
    n = a.shape[0]
    x = res.x.numpy()[:n]
    assert (np.linalg.norm(b[:n] - a.to_dense() @ x)
            / np.linalg.norm(b[:n])) <= 2e-8


def test_spd_and_apply_state():
    m, _, a = build((16, 16), {"coarse: max size": 64})
    assert len(m.levels) == 2
    n = a.shape[0]
    v = torch.from_numpy(rhs(m, n, 2))
    w = torch.from_numpy(rhs(m, n, 3))
    s1, s2 = float(v @ m.apply(w)), float(w @ m.apply(v))
    assert abs(s1 - s2) <= 1e-11 * abs(s1)
    assert float(v @ m.apply(v)) > 0
    np.testing.assert_allclose(m.apply_state(m.state(), v).numpy(),
                               m.apply(v).numpy(), rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="single-vector"):
        m.apply(torch.stack([v, w], 1))


def test_w_cycle_matches_jax():
    # b = 3 then b = 6: the level-1 cycle runs twice per level-0 visit and
    # solves the coarse level twice per visit of its own
    m, jm, a = build((8, 8, 4), {"coarse: max size": 40, "cycle type": "W"})
    assert len(m.levels) == 2
    r = rhs(m, a.shape[0], 4)
    assert rel(m.apply(torch.from_numpy(r)).numpy(),
               jm.apply(jnp.asarray(r))) <= 1e-12


def test_size_validation():
    a = elasticity2d(8, 8, e_mod=1.0)
    ns = rigid_body_modes(8, 8)
    for kw in (dict(node_dims=(8, 4), nullspace=ns),
               dict(node_dims=(8, 8), nullspace=ns[:-2]),
               dict(node_dims=(8, 8, 1), nullspace=ns, params={"cycle": 1})):
        params = kw.pop("params", None)
        with pytest.raises(ValueError):
            BlockStructuredAmg(a, params, n_equations=2, device="cpu",
                               **kw).compute()
    odd = elasticity2d(3, 3, e_mod=1.0)
    with pytest.raises(ValueError, match="no even axis"):
        BlockStructuredAmg(odd, node_dims=(3, 3),
                           nullspace=rigid_body_modes(3, 3), n_equations=2,
                           device="cpu").compute()
    with pytest.raises(TypeError, match="CsrHost"):
        BlockStructuredAmg(np.eye(4), node_dims=(2, 2), nullspace=np.eye(4),
                           n_equations=1, device="cpu").compute()


def test_bf16_hierarchy_iteration_count():
    """A bf16-stored hierarchy preconditions f32 CG within two iterations
    of the f32 one, as the JAX package's test holds."""
    dims = (24, 24)
    a = elasticity2d(*dims, e_mod=1.0)
    mf = BlockStructuredAmg(a, {"dtype": np.float32}, node_dims=dims,
                            nullspace=rigid_body_modes(*dims), n_equations=2,
                            device="cpu").compute()
    mb = BlockStructuredAmg(a, {"dtype": torch.bfloat16}, node_dims=dims,
                            nullspace=rigid_body_modes(*dims), n_equations=2,
                            device="cpu").compute()
    assert mb.levels[0]["a"].dtype == torch.bfloat16
    assert mb.coarse_inv.dtype == torch.bfloat16
    b = torch.from_numpy(rhs(mf, a.shape[0], 0, np.float32))
    op = mf.fine_op
    rf = cg(lambda v: spmv(op, v), b, prec=mf, rtol=1e-5, maxiter=100)
    rb = cg(lambda v: spmv(op, v), b, prec=mb, rtol=1e-5, maxiter=100)
    assert bool(rf.converged) and bool(rb.converged)
    assert rb.x.dtype == torch.float32
    assert rb.iters <= rf.iters + 2


@pytest.mark.parametrize("dims,coarse_max,jdtype", [((8, 8), 8, None),
                                                    ((8, 8, 4), 40, None),
                                                    ((8, 8), 40, "bf16")])
def test_state_from_jax_gives_the_jax_cycle(dims, coarse_max, jdtype):
    """The JAX hierarchy's state carried into the port (3-D lane-packed
    and 4-D BDIA data, b = 2, 3 and 6, bf16 widened exactly) gives the JAX
    V-cycle through the port's apply_state."""
    dt = None if jdtype is None else (torch.bfloat16, jnp.bfloat16)
    m, jm, a = build(dims, {"coarse: max size": coarse_max}, dtype=dt)
    jst = jax.tree_util.tree_map(np.asarray, jm.state())
    st = block_amg_state_from_jax(jst, device="cpu")
    assert [lv["a"].data.shape[1:3] for lv in st["levels"]] == [
        (lv["bk"][0],) * 2 for lv in m.levels]
    for lv, jlv in zip(st["levels"], jst["levels"]):
        np.testing.assert_array_equal(lv["a"].data.double().numpy(),
                                      np.asarray(jlv["a"].data_flat,
                                                 np.float64))
    r = rhs(m, a.shape[0], 5, np.float32 if jdtype else np.float64)
    want = np.asarray(jm.apply(jnp.asarray(r)))
    got = m.apply_state(st, torch.from_numpy(r)).numpy()
    assert rel(got, want) <= (1e-6 if jdtype else 1e-12)
    if jdtype is None:
        assert rel(m.apply(torch.from_numpy(r)).numpy(), want) <= 1e-12
    bdia_spmv.launches = 0
    m.apply(torch.from_numpy(r))
    assert bdia_spmv.launches == 0
