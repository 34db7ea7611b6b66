"""The port's distributed kind gates (``parallel/solve_kinds.py``) and the
rank body of ``entry.dryrun_multichip`` in real rank processes, against
the JAX package's ``run_all_solver_kinds(4)`` / ``run_all_eigen_kinds(4)``
on its 4-device CPU mesh — the twin of ``tests/test_smoke_solvers.py``.

The group of 4 of ``torch_dist_reference.ranks_port`` runs
``dryrun_rank`` (``torch_dist_tasks.ranks_spmv``): both gates, then the
dryrun's distributed solves. The JAX side is this file's own: the solver
gate in three parts (``jax_solver_kinds`` over ``SOLVER_GROUPS``: the
JAX package's ``run_all_solver_kinds(4)`` with its factory table cut to
a part's kinds, about 270 s of compiles in all) and the eigensolver gate
whole (``jax_eigen_kinds``), each a shared computation read by one test.
The three solver tests sit apart in the file, so that the run's workers
take them in different batches and compute the parts side by side.

Tolerances: the solver gates run in float32 at rtol 1e-4 for at most 6
iterations (GMRES kinds: 8 with restart 4), so each kind's x agrees with
the JAX package's to float32 rounding amplified by a few steps (1e-5
relative). Block GCRO-DR solves for [b, b/2], a block of rank one, so its
second Krylov column is rounding noise: x differs by about 1e-2 and the
residual norms by 2e-2 (the port's own f32 and f64 runs part by 6e-2 in
x and 1e-1 in the norms on one process). It is held to the JAX package's
residual norms within 1e-1, and its norms to the true residual of its
gathered x to 1e-4. BiCGStab and LSQR may stop one iteration apart (ROADMAP
queue 3). ``stochastic_cg`` draws from ``jax.random`` in the JAX package,
so only its count and finiteness are compared. Eigenvalues are compared
as sorted sets (Generalized Davidson's order follows rounding over ranks)
to 1e-6 relative, the gates' float64 problems at tol 1e-3.
"""
import numpy as np
import pytest
import torch

import torch_dist_reference as R
import torch_dist_tasks as T
from torch_threads import one_thread  # noqa: F401  (autouse)
from trilinos_tpu_torch.eigen import factory as efct
from trilinos_tpu_torch.parallel import solve_kinds as SK
from trilinos_tpu_torch.parallel.comm import SerialComm
from trilinos_tpu_torch.parallel.map import Map
from trilinos_tpu_torch.solvers import factory as fct

P = R.P
X_TOL = 1e-5
RESNORM_TOL = 1e-1  # block GCRO-DR's residual norms (see above)
TRUE_RES_TOL = 1e-4  # its norms against its x's true residual, f32
EIG_TOL = 1e-6
ITERS_SLACK = {"bicgstab": 1, "lsqr": 1}
SOLVER_KINDS = sorted(set(fct.ALIASES.values()))
EIGEN_KINDS = sorted(["lobpcg", "davidson", "gen_davidson", "tracemin",
                      "rtr", "bks", "lanczos", "power", "lobpcg+M",
                      "davidson+M", "gen_davidson+M", "tracemin+M", "rtr+M",
                      "bks+M"])
# the solver gate's kinds in three parts of about equal cost (the JAX
# package's compile times on the CPU)
SOLVER_GROUPS = (
    ("gmres_pipe", "fgmres", "bicgstab", "cg", "minres", "lsqr",
     "hybrid_gmres"),
    ("gmres_sr", "gmres", "block_gmres", "tfqmr", "cg_pipeline", "rcg"),
    ("stochastic_cg", "pcpg", "sstep", "fixed_point", "block_cg",
     "cg_single_reduce", "gcrodr", "block_gcrodr"))
DRYRUN_STEPS = ("cg_pipeline", "amg", "amg_blocks", "cheb_fused",
                "amg_structured", "sstep", "lsqr", "grid_cg", "grid_gmres",
                "md_cg")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return R.twins(R.ranks_port(tmp_path_factory), "dryrun")


def _unpad(rmap, xp):
    if xp.ndim == 1:
        return rmap.from_padded(xp)
    return np.stack([rmap.from_padded(xp[:, j]) for j in range(xp.shape[1])],
                    axis=1)


def _gathered(ranks, kind):
    rmap = Map.uniform(12 * 2 * P, P)
    return _unpad(rmap, np.concatenate([r["solver_kinds"][kind]["x"]
                                        for r in ranks]))


def _values(res):
    v = res[0] if isinstance(res, (tuple, list)) else res["eigenvalues"]
    return np.sort_complex(np.atleast_1d(np.asarray(v)).astype(complex))


def _solver_kind_mismatch(ranks, want, kind):
    """Why ``kind``'s result differs from the JAX package's, or None."""
    its = [r["solver_kinds"][kind]["iters"] for r in ranks]
    if len(set(its)) != 1:
        return f"iterations differ over the ranks: {its}"
    if abs(its[0] - want["iters"]) > ITERS_SLACK.get(kind, 0):
        return f"{its[0]} iterations, the JAX package's {want['iters']}"
    x = _gathered(ranks, kind)
    if x.shape != want["x"].shape or not np.isfinite(x).all():
        return f"x of shape {x.shape}, finite {np.isfinite(x).all()}"
    if kind == "stochastic_cg":
        return None
    if kind == "block_gcrodr":
        rn = np.asarray(ranks[0]["solver_kinds"][kind]["resnorm"])
        a = T.laplace2d(12, 2 * P).to_dense()
        b = np.random.default_rng(0).standard_normal(a.shape[0]).astype(
            np.float32).astype(np.float64)
        true = np.linalg.norm(np.stack([b, 0.5 * b], axis=1) - a @ x,
                              axis=0)
        if not (np.allclose(rn, want["resnorm"], rtol=RESNORM_TOL, atol=0)
                and np.allclose(rn, true, rtol=TRUE_RES_TOL, atol=0)):
            return (f"residual norms {rn}, the JAX package's "
                    f"{want['resnorm']}, true {true}")
        return None
    err = np.abs(x - want["x"]).max() / np.abs(want["x"]).max()
    return None if err <= X_TOL else f"x {err:.3e} from the JAX package's"


def _check_solver_group(ranks, tmp_path_factory, part):
    kinds = SOLVER_GROUPS[part]
    ref = T.shared(f"torch_dist_jax_solver_kinds_{part}",
                   lambda: R.jax_solver_kinds(kinds), tmp_path_factory)
    assert set(ref) == set(kinds)
    bad = {k: why for k in kinds
           if (why := _solver_kind_mismatch(ranks, ref[k], k)) is not None}
    assert not bad, bad


def test_solver_kinds_part_0_match_jax(ranks, tmp_path_factory):
    _check_solver_group(ranks, tmp_path_factory, 0)


def test_every_solver_kind_covered(ranks):
    assert sorted(sum(SOLVER_GROUPS, ())) == SOLVER_KINDS
    for r in ranks:
        assert set(r["solver_kinds"]) == set(SOLVER_KINDS)


def test_every_eigen_kind_matches_jax(ranks, tmp_path_factory):
    ref = T.shared("torch_dist_jax_eigen_kinds", R.jax_eigen_kinds,
                   tmp_path_factory)
    assert set(ref) == set(EIGEN_KINDS)
    for r in ranks:
        assert set(r["eigen_kinds"]) == set(EIGEN_KINDS)
        assert {k.split("+")[0] for k in r["eigen_kinds"]} == set(
            efct.ALIASES.values())
    bad = {}
    for kind in EIGEN_KINDS:
        got = [_values(r["eigen_kinds"][kind]) for r in ranks]
        want = np.sort_complex(np.atleast_1d(ref[kind]).astype(complex))
        if not all(np.array_equal(g, got[0]) for g in got[1:]):
            bad[kind] = f"values differ over the ranks: {got}"
        elif not (np.isfinite(got[0]).all() and got[0].shape == want.shape
                  and np.allclose(got[0], want, rtol=EIG_TOL, atol=0)):
            bad[kind] = f"{got[0]}, the JAX package's {want}"
    assert not bad, bad


@pytest.mark.parametrize("step", DRYRUN_STEPS)
def test_dryrun_steps_ran_on_every_rank(ranks, step):
    its = {r["steps"][step]["iters"] for r in ranks}
    assert len(its) == 1 and its.pop() > 0
    for r in ranks:
        assert np.isfinite(r["steps"][step]["x"]).all()


def test_dryrun_applies_and_eigensolves(ranks):
    for r in ranks:
        s = r["steps"]
        for key in ("spmv_t", "md_apply", "dense"):
            assert np.isfinite(s[key]).all(), key
        assert s["lobpcg"]["eigenvalues"].shape == (2,)
        # M = A: the pencil's eigenvalues are 1
        np.testing.assert_allclose(s["lobpcg+M"]["eigenvalues"], 1.0,
                                   rtol=1e-3)
        np.testing.assert_array_equal(s["dense"], ranks[0]["steps"]["dense"])


def test_solver_kinds_part_1_match_jax(ranks, tmp_path_factory):
    _check_solver_group(ranks, tmp_path_factory, 1)


# -- in process, without ranks ----------------------------------------------

def test_missing_solver_kind_raises_before_any_solve(monkeypatch):
    monkeypatch.setitem(fct.ALIASES, "__FAKE", "not_a_kind")
    with pytest.raises(RuntimeError, match="no distributed coverage"):
        SK.run_all_solver_kinds(SerialComm(), "cpu")


def test_missing_eigen_kind_raises(monkeypatch):
    monkeypatch.setitem(efct.ALIASES, "__FAKE", "not_a_kind")
    with pytest.raises(RuntimeError, match="no distributed coverage"):
        SK.run_all_eigen_kinds(SerialComm(), "cpu")


def test_broken_adapter_reported_with_every_other_failure(monkeypatch):
    """A broken adapter, a broken global-view kind and a broken LSQR are
    reported together in one error, after every kind ran."""
    real = SK._shard_map_adapters

    def broken_adapters(rtol, maxiter):
        out = real(rtol, maxiter)

        def boom(*a, **k):
            raise ValueError("adapter broken on purpose")
        out["cg"] = boom
        return out

    real_g = SK._global_view_kinds

    def broken_global(*a, **k):
        out = real_g(*a, **k)
        out["rcg"] = lambda: 1 / 0
        return out

    from trilinos_tpu_torch.parallel import driver as drv
    monkeypatch.setattr(SK, "_shard_map_adapters", broken_adapters)
    monkeypatch.setattr(SK, "_global_view_kinds", broken_global)
    monkeypatch.setattr(drv, "dist_lsqr", lambda *a, **k: torch.zeros(1))
    with pytest.raises(RuntimeError) as err:
        SK.run_all_solver_kinds(SerialComm(), "cpu")
    msg = str(err.value)
    assert msg.startswith("3 distributed solver kind(s) FAILED")
    assert "cg (ranks [0]): ValueError: adapter broken on purpose" in msg
    assert "rcg (ranks [0]): ZeroDivisionError" in msg
    assert "lsqr (ranks [0]): AttributeError" in msg
    assert "gmres" not in msg


class _PeerComm:
    """Two ranks seen from rank 0, the peer's flags given: psum adds
    them."""

    size = 2

    def __init__(self, peer_row):
        self.peer_row = peer_row

    def index(self):
        return 0

    def psum(self, x):
        out = x.clone()
        out[1] = torch.as_tensor(self.peer_row, dtype=x.dtype)
        return out


def test_verdict_raises_for_a_failure_on_another_rank():
    """Rank 0 saw no failure, rank 1 did: rank 0 raises as well."""
    kinds = ["cg", "gmres"]
    with pytest.raises(RuntimeError, match=r"gmres \(ranks \[1\]\): "
                                           "failed on another rank"):
        SK._verdict(_PeerComm([0.0, 1.0]), kinds, {}, "cpu", "solver")
    SK._verdict(_PeerComm([0.0, 0.0]), kinds, {}, "cpu", "solver")


def test_gates_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for gate in (SK.run_all_solver_kinds, SK.run_all_eigen_kinds):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            gate(SerialComm())


def test_solver_kinds_part_2_match_jax(ranks, tmp_path_factory):
    _check_solver_group(ranks, tmp_path_factory, 2)
