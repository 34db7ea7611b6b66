"""The port's solver factory, Stratimikos ``build`` and the ninth slice's
entry points against the JAX package's.

``ALIASES`` and ``_SPECS`` equal the reference's key for key. The first
name of each of the 21 kinds solves laplace2d(14, 14) (DIA from one host
matrix, f64, rtol 1e-9) through both packages' ``SolverManager``, and
every other name through the port's, giving its kind's result bit for
bit. Against the reference: equal iteration counts and x to 1e-10
(max|Δ| / max|x|), except BiCGStab,
whose ω steps amplify rounding on this symmetric matrix (±1 iteration,
each x held to the true-residual gate), and the block kinds solved with
one column. LSQR and PCPG first raise the reference's own error without
``op_t`` / ``constraint_basis``, then solve with them. ``build`` with and
without a preconditioner, and the bf16-basis refusal. The entries on the
CPU at small sizes, f64: ``factory_entry`` (structured AMG on Laplace3D
8³) against the JAX package's manager on its own hierarchy, equal
iterations and x to 1e-10; ``pipelined_cg_entry`` at 12³ (the JAX BASELINE
test's size) against ``cg_pipeline``, with the test's true-residual gate;
``build_entry`` at 8³. Each entry raises without a card unless asked for
the CPU.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trilinos_tpu.galeri import laplace2d as j_laplace2d
from trilinos_tpu.galeri import laplace3d as j_laplace3d
from trilinos_tpu.ops import formats as JF
from trilinos_tpu.ops import matvec as JS
from trilinos_tpu.precond import SaAmg as JSaAmg
from trilinos_tpu.solvers import LinearProblem as JProblem
from trilinos_tpu.solvers import build as j_build
from trilinos_tpu.solvers import cg_pipeline as j_cg_pipeline
from trilinos_tpu.solvers import factory as jfactory

from trilinos_tpu_torch.entry import (build_entry, factory_entry,
                                      pipelined_cg_entry)
from trilinos_tpu_torch.ops import formats as TF
from trilinos_tpu_torch.ops import matvec as TS
from trilinos_tpu_torch.ops import dia_spmv, stencil_spmm, stencil_spmv
from trilinos_tpu_torch.solvers import (LinearProblem, SolverManager, build,
                                        create_solver, factory,
                                        solver_names)
from torch_threads import one_thread  # noqa: F401  (autouse)

X_TOL = 1e-10
A = j_laplace2d(14, 14)
JA = JF.csr_to_dia(A, dtype=np.float64)
TA = TF.csr_to_dia(TF.CsrHost(A.row_ptr, A.cols, A.vals, A.shape),
                   device="cpu")
NPAD, N = JA.n_rows_pad, A.shape[0]
DENSE = A.to_dense()


def jop(x):
    return JS.spmv(JA, x, impl="xla")


def top(x):
    return TS.spmv(TA, x)


def rhs(k=None, seed=7, n=N, npad=NPAD):
    b = np.zeros((npad,) if k is None else (npad, k))
    b[:n] = np.random.default_rng(seed).standard_normal(b[:n].shape)
    return b


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def true_rel(b, x):
    r = b[:N] - DENSE @ np.asarray(x)[:N]
    return np.linalg.norm(r, axis=0) / np.linalg.norm(b[:N], axis=0)


def test_tables_equal_the_reference():
    assert factory.ALIASES == jfactory.ALIASES
    assert factory._SPECS.keys() == jfactory._SPECS.keys()
    for key, spec in jfactory._SPECS.items():
        mine = factory._SPECS[key]
        assert (mine.name, mine.default, mine.choices) == (
            spec.name, spec.default, spec.choices), key
    assert solver_names() == jfactory.solver_names()
    assert len(solver_names()) == 30 and len(set(factory.ALIASES.values())) \
        == 21


# names whose iteration count follows rounding on this matrix
ROUNDING = {"BICGSTAB"}
PARAMS = {"Convergence Tolerance": 1e-9, "Maximum Iterations": 20000}
# Richardson converges on this matrix (λmax ≈ 7.9) only for ω < 0.25
EXTRA_PARAMS = {"fixed_point": {"Fixed Point Omega": 0.2},
                "hybrid_gmres": {"Maximum Degree": 8}}
# the first name of each kind is held to the JAX package, its aliases to it
CANONICAL = {}
for _name in solver_names():
    CANONICAL.setdefault(factory.ALIASES[_name], _name)
_PORT_RESULTS = {}


def port_problem(kind, b):
    """The port's LinearProblem on b, with the transpose (LSQR) or the
    constraint basis (PCPG, the three lowest eigenvectors) a kind needs;
    and the same inputs for the JAX package."""
    tp, extra = LinearProblem(top, torch.from_numpy(b)), {}
    if kind == "lsqr":
        extra = dict(op_t=(
            lambda x: JS.spmv(JA, x, transpose=True, impl="xla"),
            lambda x: TS.spmv(TA, x, transpose=True)))
    elif kind == "pcpg":
        u = np.zeros((NPAD, 3))
        u[:N] = np.linalg.eigh(DENSE)[1][:, :3]
        extra = dict(constraint_basis=(jnp.asarray(u), torch.from_numpy(u)))
    for attr, (_, tv) in extra.items():
        setattr(tp, attr, tv)
    return tp, extra


def port_solve(name, b):
    kind = factory.ALIASES[name]
    params = {**PARAMS, **EXTRA_PARAMS.get(kind, {})}
    tp, extra = port_problem(kind, b)
    return SolverManager(name, dict(params)).solve(tp), params, extra


@pytest.mark.parametrize("name", sorted(CANONICAL.values()))
def test_every_kind_solves_like_the_reference(name):
    b = rhs()
    kind = factory.ALIASES[name]
    if kind in ("lsqr", "pcpg"):
        # the reference's own error without the extra input, in both
        with pytest.raises(ValueError, match="op_t|constraint_basis"):
            jfactory.SolverManager(name, dict(PARAMS)).solve(
                JProblem(jop, jnp.asarray(b)))
        with pytest.raises(ValueError, match="op_t|constraint_basis"):
            SolverManager(name, dict(PARAMS)).solve(
                LinearProblem(top, torch.from_numpy(b)))
    tr, params, extra = port_solve(name, b)
    jp = JProblem(jop, jnp.asarray(b))
    for attr, (jv, _) in extra.items():
        setattr(jp, attr, jv)
    jr = jfactory.SolverManager(name, dict(params)).solve(jp)
    assert tr.x.shape == b.shape
    assert bool(np.all(np.asarray(tr.converged)))
    assert (true_rel(b, tr.x) <= 1e-8).all()
    if name in ROUNDING:
        assert abs(int(tr.iters) - int(jr.iters)) <= 1
        assert (true_rel(b, jr.x) <= 1e-8).all()
    else:
        assert int(tr.iters) == int(jr.iters)
        assert rel(tr.x.numpy(), jr.x) <= X_TOL


@pytest.mark.parametrize("name", sorted(set(solver_names())
                                        - set(CANONICAL.values())))
def test_every_alias_solves_as_its_kind(name):
    """The other names of a kind give the canonical name's result."""
    b = rhs()
    tr, _, _ = port_solve(name, b)
    want, _, _ = port_solve(CANONICAL[factory.ALIASES[name]], b)
    assert tr.iters == want.iters
    assert torch.equal(tr.x, want.x)
    assert bool(np.all(np.asarray(tr.converged)))


@pytest.mark.parametrize("name", ["Block CG", "Block GCRODR",
                                  "Pseudoblock CG", "TFQMR"])
def test_block_of_columns_like_the_reference(name):
    b = rhs(3, seed=8)
    jr = jfactory.SolverManager(name, dict(PARAMS)).solve(
        JProblem(jop, jnp.asarray(b)))
    tr = SolverManager(name, dict(PARAMS)).solve(
        LinearProblem(top, torch.from_numpy(b)))
    assert int(tr.iters) == int(jr.iters)
    assert rel(tr.x.numpy(), jr.x) <= X_TOL
    assert (true_rel(b, tr.x) <= 1e-8).all()


def test_unknown_name_and_invalid_choice_raise():
    with pytest.raises(ValueError, match="unknown solver"):
        create_solver("Super Solver")
    with pytest.raises(ValueError):
        create_solver("GMRES", {"Orthogonalization": "QR-ish"})
    with pytest.raises(ValueError):
        create_solver("CA-GMRES", {"Step Basis": "Chebyshev"})


TA32 = TF.csr_to_dia(TF.CsrHost(A.row_ptr, A.cols, A.vals, A.shape),
                     dtype=np.float32, device="cpu")


def test_bf16_basis_refused_where_not_implemented():
    b = torch.from_numpy(rhs())
    for name in ("CG", "MINRES", "GCRODR", "LSQR"):
        with pytest.raises(ValueError, match="Basis Precision"):
            SolverManager(name, {"Basis Precision": "bf16"}).solve(
                LinearProblem(top, b))
    res = SolverManager("GMRES", {"Basis Precision": "bf16",
                                  "Convergence Tolerance": 1e-6,
                                  "Maximum Iterations": 2000}).solve(
        LinearProblem(lambda v: TS.spmv(TA32, v),
                      torch.from_numpy(rhs()).float()))
    assert bool(res.converged)


def test_build_with_and_without_preconditioner():
    params = {"Linear Solver Type": "GMRES",
              "Solver Types": {"GMRES": {"Num Blocks": 30,
                                         "Convergence Tolerance": 1e-9}},
              "Preconditioner Type": "CHEBYSHEV",
              "Preconditioner Types": {"CHEBYSHEV": {
                  "chebyshev: degree": 3}}}
    jmgr, jprec = j_build(params, a_csr=A)
    tmgr, tprec = build(params, a_csr=TF.CsrHost(A.row_ptr, A.cols, A.vals,
                                                 A.shape), device="cpu")
    assert tmgr.kind == jmgr.kind == "gmres"
    assert tprec.degree == 3 and abs(tprec.lmax - jprec.lmax) <= 1e-12
    b = rhs()
    jr = jmgr.solve(JProblem(jop, jnp.asarray(b), right_prec=jprec))
    tr = tmgr.solve(LinearProblem(top, torch.from_numpy(b), right_prec=tprec))
    assert int(tr.iters) == int(jr.iters)
    assert rel(tr.x.numpy(), jr.x) <= X_TOL
    assert true_rel(b, tr.x) <= 1e-8
    mgr, prec = build({"Linear Solver Type": "CG"})
    assert prec is None and mgr.kind == "cg"
    with pytest.raises(ValueError, match="no matrix"):
        build({"Preconditioner Type": "CHEBYSHEV"})


NEW_PRECONDITIONERS = [
    ("RILUK", {"fact: iluk level-of-fill": 1}), ("RBILUK", {}), ("ILU", {}),
    ("ILU(0)", {}), ("ILUT", {}), ("BLOCK RELAXATION", {}),
    ("TRIDI", {"relaxation: container": "TriDi"}),
    ("BANDED RELAXATION", {"relaxation: container": "Banded"}),
    ("DATABASE SCHWARZ", {"relaxation: container": "Database"}),
    ("MT GAUSS-SEIDEL", {}), ("GAUSS-SEIDEL", {}), ("SCHWARZ", {}),
    ("ADDITIVE SCHWARZ", {"schwarz: combine mode": "add"}), ("HIPTMAIR", {})]


@pytest.mark.parametrize("name,pparams", NEW_PRECONDITIONERS,
                         ids=[n for n, _ in NEW_PRECONDITIONERS])
def test_build_accepts_every_new_preconditioner(name, pparams):
    """Each preconditioner name this slice ports, through ``build`` with
    GMRES(30) at rtol 1e-8 on recirc2d(12, 12) (HIPTMAIR: maxwell2d(6, 5)
    with its discrete gradient as ``aux_op``), f64: the preconditioner is
    the reference's class, its apply equals the JAX package's to 1e-12, and
    the solve converges to the true-residual gate."""
    from trilinos_tpu import precond as jprec
    from trilinos_tpu.galeri import recirc2d as j_recirc2d
    from trilinos_tpu.galeri.stencils import maxwell2d as j_maxwell2d

    kw, jkw = {}, {}
    if name == "HIPTMAIR":
        a, g = j_maxwell2d(6, 5, sigma=0.1)
        kw = {"aux_op": TF.CsrHost(g.row_ptr, g.cols, g.vals, g.shape)}
        jkw = {"aux_op": g}
    else:
        a = j_recirc2d(12, 12, diff=1e-2)
    params = {"Linear Solver Type": "GMRES",
              "Solver Types": {"GMRES": {"Num Blocks": 30,
                                         "Convergence Tolerance": 1e-8,
                                         "Maximum Iterations": 1000}},
              "Preconditioner Type": name,
              "Preconditioner Types": {name: dict(pparams)}}
    ta = TF.CsrHost(a.row_ptr, a.cols, a.vals, a.shape)
    mgr, m = build(params, a_csr=ta, device="cpu", **kw)
    jm = jprec.create(name, a, dict(pparams), **jkw).compute()
    assert type(m).__name__ == type(jm).__name__
    dev = TF.choose_format(ta, device="cpu")
    n, npad = a.shape[0], dev.n_rows_pad
    b = np.zeros(npad)
    b[:n] = np.random.default_rng(6).standard_normal(n)
    assert rel(m(torch.from_numpy(b)).numpy(), jm.apply(jnp.asarray(b))) \
        <= 1e-12
    res = mgr.solve(LinearProblem(lambda v: TS.spmv(dev, v),
                                  torch.from_numpy(b), right_prec=m))
    assert bool(torch.as_tensor(res.converged).all())
    r = b[:n] - a.to_dense() @ res.x.numpy()[:n]
    assert np.linalg.norm(r) <= 1e-7 * np.linalg.norm(b[:n])


# -- the entries ------------------------------------------------------------
ENTRY_DIMS = (8, 8, 8)
_JAMG = []


def jax_hierarchy():
    if not _JAMG:
        op = j_laplace3d(*ENTRY_DIMS, dtype=np.float64, fmt="stencil")
        m = JSaAmg(op, {"dtype": np.float64}).compute()
        _JAMG.append((op, m, m.state()))
    return _JAMG[0]


@pytest.mark.parametrize("name,params,nrhs", [
    ("CG", {"Estimate Condition Number": 20,
            "Record Residual History": True}, None),
    ("Pipelined CG", None, None), ("MINRES", None, None),
    ("TFQMR", None, None), ("RCG", None, None),
    ("GCRODR", {"Num Blocks": 30, "Num Recycled Blocks": 8}, None),
    ("Hybrid Block GMRES", {"Maximum Degree": 4}, None),
    ("LSQR", {"Convergence Tolerance": 0.0, "Maximum Iterations": 20},
     None),
    ("Block CG", None, 4), ("Block GCRODR", None, 4)])
def test_factory_entry_matches_jax(name, params, nrhs):
    p = {"Convergence Tolerance": 1e-8, **(params or {})}
    stencil_spmv.launches = stencil_spmm.launches = dia_spmv.launches = 0
    step, (b, st) = factory_entry(name, dict(p), dims=ENTRY_DIMS, nrhs=nrhs,
                                  dtype=np.float64, device="cpu")
    res = step(b, st)
    jop_, jm, jst = jax_hierarchy()
    jp = JProblem(lambda v: JS.spmv(jop_, v), jnp.asarray(b.numpy()))
    if name == "LSQR":
        assert st is None
        jp.op_t = lambda v: JS.spmv(jop_, v, transpose=True)
    else:
        jp.right_prec = lambda v: jm.apply_state(jst, v)
    jr = jfactory.SolverManager(name, dict(p)).solve(jp)
    assert int(res.iters) == int(jr.iters)
    assert rel(res.x.numpy(), jr.x) <= X_TOL
    assert stencil_spmv.launches == stencil_spmm.launches == \
        dia_spmv.launches == 0
    if name == "CG":
        assert abs(float(res.condest) - float(jr.condest)) <= 1e-10 * float(
            jr.condest)
        h = res.history.numpy()
        np.testing.assert_array_equal(np.isnan(h), np.isnan(jr.history))
    if name == "GCRODR":  # the second solve reuses the first one's space
        assert step.manager.recycle_space.size == 8
        res2 = step(b, st)
        assert bool(res2.converged)


def test_pipelined_cg_entry_matches_jax():
    """BASELINE config 4 at the JAX test's 12³ on one device: DIA f64,
    unpreconditioned cg_pipeline at rtol 1e-8, seed-3 right-hand side."""
    step, (b,) = pipelined_cg_entry(dims=(12, 12, 12), device="cpu")
    res = step(b)
    a = j_laplace3d(12, 12, 12)
    n = a.shape[0]
    want_b = np.random.default_rng(3).standard_normal(n)
    np.testing.assert_array_equal(b.numpy()[:n], want_b)
    assert not b.numpy()[n:].any()
    ja = JF.csr_to_dia(a, dtype=np.float64)
    jr = j_cg_pipeline(lambda v: JS.spmv(ja, v, impl="xla"),
                       jnp.asarray(b.numpy()), rtol=1e-8)
    assert res.iters == int(jr.iters)
    assert rel(res.x.numpy(), jr.x) <= X_TOL
    # the stored matrix the solve ran on: 7 diagonals, the entry's rows
    assert len(step.matrix.offsets) == 7
    assert step.matrix.n_rows_pad == b.shape[0]
    x = res.x.numpy()[:n]
    assert (np.linalg.norm(want_b - a.to_dense() @ x)
            <= 1.1e-8 * np.linalg.norm(want_b))


def test_build_entry_on_the_cpu():
    """CG + Chebyshev (degree 3) converges; GMRES(10) + GmresPoly (degree
    10) at a fixed 10 iterations (rtol 0) ends below 10 plain GMRES(10)
    iterations (the card runs GMRES(30) for 60; at 8³ both would reach
    rounding level)."""
    a = j_laplace3d(*ENTRY_DIMS)
    dense = a.to_dense()
    host = TF.CsrHost(a.row_ptr, a.cols, a.vals.astype(np.float32), a.shape)
    step, (b,) = build_entry(dims=ENTRY_DIMS, device="cpu", a=host,
                             params={"Convergence Tolerance": 1e-5})
    res = step(b)
    assert step.preconditioner.degree == 3
    n = a.shape[0]
    bn = b.numpy()[:n].astype(np.float64)

    def tr(x):
        return np.linalg.norm(bn - dense @ x.numpy()[:n]) / np.linalg.norm(bn)

    assert bool(res.converged) and tr(res.x) <= 1e-5
    fixed = {"Num Blocks": 10, "Convergence Tolerance": 0.0,
             "Maximum Iterations": 10}
    residuals = []
    for prec in ("GMRESPOLY", "None"):
        step, (b,) = build_entry("GMRES", prec, dims=ENTRY_DIMS, a=host,
                                 params=fixed, device="cpu")
        res = step(b)
        assert res.iters == 10
        residuals.append(tr(res.x))
    assert residuals[0] < residuals[1]


def test_new_entries_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for fn in (lambda: factory_entry("CG"), pipelined_cg_entry,
               lambda: build_entry(dims=(4, 4, 4))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()
