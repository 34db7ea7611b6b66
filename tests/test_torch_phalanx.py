"""Port parity: Phalanx's evaluator DAG and Panzer's physics block
(``trilinos_tpu_torch/fem/phalanx.py``) against the JAX package's
``fem/phalanx.py``, float64 on the CPU.

The DAG: the same evaluator graphs give the same schedule (evaluator
names in order) and the same diagnostics, message for message (cycle,
missing provider, duplicate provider), with aliases and multi-output
evaluators, and every evaluator runs once. The physics block: the nonlinear
Poisson flux (1 + u²)∇u with source 4 assembled through the DAG on seeded
u, on Q1 quadrilaterals and hexahedra and on Q2 quadrilaterals, within
1e-13 (max|Δ| / max|r|) of the JAX package's residual; the linear DAG
equals the classical K u − b; the Dirichlet rows are u − g; the JFNK
solve of the nonlinear Poisson through the DAG residual takes the JAX
package's Newton and GMRES iterations, x within 1e-10; ``torch.func.jacfwd``
in a parameter field equals ``jax.jacfwd`` to 1e-14.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_thread  # noqa: F401  (autouse)
from trilinos_tpu import fem as jfem
from trilinos_tpu import nonlinear as jnl
from trilinos_tpu.fem import phalanx as jph
from trilinos_tpu_torch import fem
from trilinos_tpu_torch.fem import Evaluator, FieldManager, PhysicsBlock
from trilinos_tpu_torch.nonlinear import newton_krylov

R_TOL = 1e-13
X_TOL = 1e-10


def diamond(mod):
    """The diamond a -> (b, c) -> d of ``tests/test_phalanx.py`` in the
    module ``mod`` (the port's or the JAX package's phalanx)."""
    fm = mod.FieldManager()
    calls = []

    def ev(name, provides, requires, fn):
        def run(*a):
            calls.append(name)
            return fn(*a)
        fm.register(mod.Evaluator(name, provides, requires, run))

    ev("a", ("a",), ("x",), lambda x: x + 1)
    ev("b", ("b",), ("a",), lambda a: a * 2)
    ev("c", ("c",), ("a",), lambda a: a * 3)
    ev("d", ("d",), ("b", "c"), lambda b, c: b + c)
    return fm, calls


def test_topological_order_and_single_eval():
    fm, calls = diamond(fem.phalanx)
    jfm, _ = diamond(jph)
    assert [e.name for e in fm.order(["d", "b"], ["x"])] == \
        [e.name for e in jfm.order(["d", "b"], ["x"])]
    out = fm.compile(["d"], inputs=["x"])({"x": torch.tensor(1.0)})
    assert float(out["d"]) == 2 * 2 + 2 * 3
    assert calls == ["a", "b", "c", "d"]


def test_compiled_dag_under_torch_func():
    """The compiled closure is pure: torch.func.jvp traces it (the JAX
    package's jit-compose test)."""
    fm, _ = diamond(fem.phalanx)
    run = fm.compile(["d", "b"], inputs=["x"])
    y, t = torch.func.jvp(lambda x: run({"x": x})["d"],
                          (torch.tensor(2.0),), (torch.tensor(1.0),))
    assert float(y) == 3 * 2 + 3 * 3 and float(t) == 5.0


def _raises_same(build, call, exc):
    """Both packages raise ``exc`` with the same message."""
    msgs = []
    for mod in (fem.phalanx, jph):
        with pytest.raises(exc) as info:
            call(build(mod))
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]
    return msgs[0]


def test_cycle_detection():
    def build(mod):
        fm = mod.FieldManager()
        fm.register(mod.Evaluator("e1", ("p",), ("q",), lambda q: q))
        fm.register(mod.Evaluator("e2", ("q",), ("p",), lambda p: p))
        return fm
    assert "cycle" in _raises_same(build, lambda fm: fm.order(["p"]),
                                   ValueError)


def test_missing_provider():
    def build(mod):
        fm = mod.FieldManager()
        fm.register(mod.Evaluator("e", ("y",), ("z",), lambda z: z))
        return fm
    assert "no evaluator provides" in _raises_same(
        build, lambda fm: fm.order(["y"], inputs=["w"]), KeyError)


def test_duplicate_provider_rejected():
    def build(mod):
        fm = mod.FieldManager()
        fm.register(mod.Evaluator("e1", ("y",), (), lambda: 0))
        return fm

    def again(fm):
        mod = fem.phalanx if isinstance(fm, FieldManager) else jph
        fm.register(mod.Evaluator("e2", ("y",), (), lambda: 1))
    assert "already provided" in _raises_same(build, again, ValueError)


def test_alias_and_multi_output():
    fm = FieldManager()
    fm.register(Evaluator("e", ("y",), ("x",), lambda x: 2 * x))
    fm.alias("y2", "y")
    assert fm.compile(["y2"], inputs=["x"])({"x": 3.0})["y2"] == 6.0
    fm = FieldManager()
    fm.register(Evaluator("split", ("lo", "hi"), ("x",),
                          lambda x: (x - 1, x + 1)))
    out = fm.compile(["hi", "lo"], inputs=["x"])({"x": 5.0})
    assert out["lo"] == 4.0 and out["hi"] == 6.0


def nonlinear_fm(mod, xp):
    """-div((1+u²)∇u) = 4 as a DAG (``tests/test_phalanx.py``) with the
    array module ``xp`` (jnp or torch)."""
    fm = mod.FieldManager()

    @fm.add("kappa", provides="kappa_qp", requires="u_qp")
    def _k(u):
        return 1.0 + u * u

    @fm.add("flux", provides="flux_qp", requires=("kappa_qp", "grad_u_qp"))
    def _flux(k, g):
        return k[..., None] * g

    @fm.add("source", provides="source_qp", requires="x_qp")
    def _src(x):
        return 4.0 * xp.ones(x.shape[:-1], dtype=x.dtype)

    return fm


def linear_fm(mod, xp):
    fm = mod.FieldManager()

    @fm.add("flux", provides="flux_qp", requires="grad_u_qp")
    def _flux(g):
        return g

    @fm.add("source", provides="source_qp", requires="x_qp")
    def _src(x):
        return xp.ones(x.shape[:-1], dtype=x.dtype)

    return fm


def blocks(mesher, args, degree=1):
    jmesh = getattr(jfem, mesher)(*args)
    tmesh = getattr(fem, mesher)(*args)
    jb = jph.PhysicsBlock(jmesh, jfem.hgrad_basis(jmesh.topo, degree),
                          dtype=jnp.float64)
    tb = PhysicsBlock(tmesh, fem.hgrad_basis(tmesh.topo, degree),
                      dtype=torch.float64, device="cpu")
    assert tb.n_dof == jb.n_dof
    return jb, tb


@pytest.mark.parametrize("mesher,args,degree", [
    ("structured_quad_mesh", (5, 4), 1),
    ("structured_quad_mesh", (3, 3), 2),
    ("structured_hex_mesh", (3, 2, 2), 1)])
def test_physics_block_residual(mesher, args, degree):
    jb, tb = blocks(mesher, args, degree)
    bnd = tb.boundary_dofs()
    np.testing.assert_array_equal(bnd, jb.boundary_dofs())
    u = np.random.default_rng(2).standard_normal(tb.n_dof)
    for kw in ({}, {"dirichlet": bnd, "g": 0.25}):
        rj = jb.residual_function(nonlinear_fm(jph, jnp), **kw)
        rt = tb.residual_function(nonlinear_fm(fem.phalanx, torch), **kw)
        want = np.asarray(rj(jnp.asarray(u)))
        got = rt(torch.from_numpy(u)).numpy()
        assert np.abs(got - want).max() <= R_TOL * np.abs(want).max()


def test_linear_poisson_matches_matrix_path():
    """flux = ∇u, source = 1 through the DAG equals K u − b from the
    port's classical assembly."""
    mesh = fem.structured_quad_mesh(5, 4)
    pb = PhysicsBlock(mesh, dtype=torch.float64, device="cpu")
    r = pb.residual_function(linear_fm(fem.phalanx, torch))
    k, _, _ = fem.stiffness_matrix(mesh)
    b, _, _ = fem.load_vector(mesh, lambda x: np.ones(x.shape[:-1]))
    u = np.random.default_rng(0).standard_normal(pb.n_dof)
    np.testing.assert_allclose(r(torch.from_numpy(u)).numpy(),
                               k.matvec_host(u) - b, atol=1e-12)


def test_dirichlet_rows():
    mesh = fem.structured_quad_mesh(4, 4)
    pb = PhysicsBlock(mesh, dtype=torch.float64, device="cpu")
    bnd = pb.boundary_dofs()
    r = pb.residual_function(linear_fm(fem.phalanx, torch), dirichlet=bnd,
                             g=0.5)
    u = np.random.default_rng(1).standard_normal(pb.n_dof)
    got = r(torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(got[bnd], u[bnd] - 0.5)


@functools.lru_cache(maxsize=None)
def jax_jfnk():
    jb, _ = blocks("structured_quad_mesh", (8, 8))
    bnd = jb.boundary_dofs()
    out = []
    for build in (nonlinear_fm, linear_fm):
        r = jb.residual_function(build(jph, jnp), dirichlet=bnd)
        out.append(jnl.newton_krylov(r, jnp.zeros(jb.n_dof), rtol=1e-10))
    return out


def test_nonlinear_poisson_jfnk():
    """JFNK Newton straight through the DAG residual (the JVP traces the
    gather, the evaluators, the out-of-place scatter and the Dirichlet
    rows): the JAX package's counts and x, for the nonlinear and the
    linear DAG."""
    _, tb = blocks("structured_quad_mesh", (8, 8))
    bnd = tb.boundary_dofs()
    xs = []
    for build, jres in zip((nonlinear_fm, linear_fm), jax_jfnk()):
        r = tb.residual_function(build(fem.phalanx, torch), dirichlet=bnd)
        res = newton_krylov(r, torch.zeros(tb.n_dof, dtype=torch.float64),
                            rtol=1e-10)
        assert res.iters == int(jres.iters)
        assert res.inner_iters == int(jres.inner_iters)
        assert res.converged and bool(jres.converged)
        assert np.abs(res.x.numpy() - np.asarray(jres.x)).max() <= X_TOL
        assert float(torch.linalg.norm(r(res.x))) < 1e-8
        xs.append(res.x.numpy())
    assert xs[0].max() > 0.1 and np.abs(xs[0][bnd]).max() < 1e-12
    assert not np.allclose(xs[0], xs[1], atol=1e-6)


def test_parameter_field_jacfwd():
    def param_fm(mod, xp):
        fm = mod.FieldManager()

        @fm.add("flux", provides="flux_qp", requires="grad_u_qp")
        def _f(g):
            return g

        @fm.add("source", provides="source_qp", requires=("x_qp", "amp"))
        def _s(x, amp):
            return amp * xp.ones(x.shape[:-1], dtype=x.dtype)

        return fm

    jb, tb = blocks("structured_quad_mesh", (3, 3))
    rt = tb.residual_function(param_fm(fem.phalanx, torch), params=("amp",))
    rj = jb.residual_function(param_fm(jph, jnp), params=("amp",))
    u = torch.zeros(tb.n_dof, dtype=torch.float64)
    r1 = rt(u, amp=torch.tensor(1.0, dtype=torch.float64)).numpy()
    r2 = rt(u, amp=torch.tensor(2.0, dtype=torch.float64)).numpy()
    np.testing.assert_allclose(r2, 2 * r1, atol=1e-14)
    dr = torch.func.jacfwd(lambda a: rt(u, amp=a))(
        torch.tensor(1.0, dtype=torch.float64))
    jdr = jax.jacfwd(lambda a: rj(jnp.zeros(jb.n_dof), amp=a))(1.0)
    np.testing.assert_allclose(dr.numpy(), np.asarray(jdr), atol=1e-14)
    np.testing.assert_allclose(dr.numpy(), r1, atol=1e-14)
