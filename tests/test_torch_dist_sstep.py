"""The port's communication-avoiding s-step GMRES over z-slabs
(``parallel.driver.dist_sstep_gmres``) in real rank processes, against the
JAX package's ``dist_sstep_gmres`` on its virtual CPU mesh — the twins of
``tests/test_dist_stencil.py`` ``TestDistSstepGmres`` and
``tests/test_krylov.py`` ``test_dist_sstep_bf16``.

One gloo group of 4 ranks (``torch_dist_reference.solve_port``) runs, on
Galeri Laplace3D 16³ (s = 3, t_blocks = 5, rtol 1e-5 in float32, the
JAX twin's settings): the fused basis (one depth-3 exchange and one
``stencil_powers_apply`` a block) and the loop basis (one exchange an
apply), a Newton basis with a conjugate pair of shifts in float64 (rtol
1e-8), and the bf16 basis on 16×8×32. Parity:

* iterations equal on every rank and to the JAX package's, each basis
  (the port's loop basis against the JAX package's fused run, which its
  own test holds to its loop run's count);
* float32: the fused and loop bases' residual norms within 1e-4 of each
  other (the JAX twin's own check), the true residual ≤ 2e-5, and x within
  1e-3 of the JAX package's. The two packages' float32 residual norms are
  not compared: at rtol 1e-5 they lie at float32's rounding floor of this
  problem (ε·‖A‖·‖x‖ ≈ 5e-4 against norms ≈ 2e-4), where the packages
  part by 2e-4 even on one card and by 1.8e-3 here;
* float64 (Newton): x within 1e-9 relative to its largest entry, the
  residual norm within 1e-6;
* σ, estimated once in rank 0 on the global operator and broadcast, is
  the single-card estimator's value: a solve given that value runs the
  same iterations to the same residual bit for bit.

``z_bounds``: the JAX package's Pallas kernel masks only the terms with
dz ≠ 0, its XLA reference (and the port) every term; on a rank slab whose
ghost planes lie past the global face the two differ on those planes, but
the owned rows of every stage agree — shown against the Pallas kernel in
interpret mode. A slab the kernel's plan refuses raises (no fallback to
the plain version). ``dist_sstep_entry`` at 16³ (4 ranks) against
``sstep_entry``: the same 160 basis vectors and x within 1e-4.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from trilinos_tpu.galeri import laplace3d as jlaplace3d
from trilinos_tpu.ops.pallas import stencil_poly as JP
from trilinos_tpu.parallel import distmatrix as JD
from trilinos_tpu_torch.galeri import laplace3d
from trilinos_tpu_torch.ops import stencil_poly as TP
from trilinos_tpu_torch.parallel import distmatrix as D
from trilinos_tpu_torch.parallel import driver as drv
from trilinos_tpu_torch.parallel.comm import SerialComm
from trilinos_tpu_torch.parallel.map import Map

import torch_dist_reference as R
import torch_dist_tasks as T
from torch_threads import one_thread  # noqa: F401  (autouse)

F32_CASES = ("fused", "loop")
F32_X_TOL = 1e-3  # x against the JAX package's, float32
F32_BASES_RTOL = 1e-4  # fused against loop (tests/test_dist_stencil.py)
F32_TRUE_MAX = 2e-5
F64_X_TOL = 1e-9
F64_RES_RTOL = 1e-6
ENTRY_X_TOL = 1e-4
ZB_GRID = (32, 32, 16)  # the Pallas kernel plans planes of ≥ 1024 points
ZB_STAGES = 3


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    return (R.solve_port(tmp_path_factory),
            T.shared("torch_dist_sstep_jax", R.jax_sstep, tmp_path_factory),
            R.amg_port(tmp_path_factory))


@pytest.fixture(scope="module")
def results(groups):
    return groups[:2]


def _x(port, case):
    rmap = Map.uniform(int(np.prod(R.SSTEP_CASES[case][0])), R.P)
    return rmap.from_padded(port[f"sstep/{case}"]["xp"])


def _true_rel(dims, b_seed, x):
    a = laplace3d(*dims)
    b = T.vectors(a.shape[0], b_seed)
    ax = sp.csr_matrix((a.vals, a.cols, a.row_ptr), shape=a.shape) @ x
    return np.linalg.norm(b - ax) / np.linalg.norm(b)


@pytest.mark.parametrize("case", sorted(R.SSTEP_CASES))
def test_iterations_match_jax(results, case):
    port, ref = results
    its = port[f"sstep/{case}"]["iters"]
    assert len(set(its)) == 1, its  # every rank ran the same iterations
    want = ref[R.JAX_SSTEP_REF[case]]
    assert its[0] == want["iters"]
    assert all(port[f"sstep/{case}"]["converged"]) and want["converged"]


@pytest.mark.parametrize("case", sorted(R.SSTEP_CASES))
def test_solution_and_residual_match_jax(results, case):
    port, ref = results
    want = ref[R.JAX_SSTEP_REF[case]]
    x = _x(port, case)
    err = np.abs(x - want["x"]).max() / np.abs(want["x"]).max()
    assert err <= (F32_X_TOL if case in F32_CASES else F64_X_TOL), err
    if case not in F32_CASES:
        res = port[f"sstep/{case}"]["ranks"][0]["resnorm"]
        assert res == pytest.approx(want["resnorm"], rel=F64_RES_RTOL)


def test_fused_and_loop_bases_agree(results):
    port, _ = results
    fused, loop = (port[f"sstep/{c}"]["ranks"][0] for c in F32_CASES)
    assert fused["iters"] == loop["iters"]
    assert fused["resnorm"] == pytest.approx(loop["resnorm"],
                                             rel=F32_BASES_RTOL)


@pytest.mark.parametrize("case", sorted(R.SSTEP_CASES))
def test_true_residual(results, case):
    port, _ = results
    dims, _, kw, seed, _ = R.SSTEP_CASES[case]
    rel = _true_rel(dims, seed, _x(port, case).astype(np.float64))
    assert rel <= (F32_TRUE_MAX if case in F32_CASES else kw["rtol"]), rel


def test_sigma_is_the_global_estimate(results):
    port, _ = results
    ranks = port["sstep/fused"]["ranks"]
    assert len({r["sigma"] for r in ranks}) == 1
    for r in ranks:
        assert r["given_iters"] == r["iters"]
        assert r["given_resnorm"] == r["resnorm"]


def test_bf16_basis_converges(results):
    """basis_dtype through the one-exchange driver (the JAX twin asserts
    convergence): every rank converges in the same iterations, to the
    tolerance in the true residual."""
    port, _ = results
    case = port["sstep/bf16"]
    assert len(set(case["iters"])) == 1 and all(case["converged"])
    rmap = Map.uniform(int(np.prod(T.SSTEP_BF16_DIMS)), R.P)
    rel = _true_rel(T.SSTEP_BF16_DIMS, 3,
                    rmap.from_padded(case["xp"]).astype(np.float64))
    assert rel <= T.SSTEP_BF16_KW["rtol"], rel


def test_rejects_stored_matrix():
    with pytest.raises(TypeError, match="StencilOp"):
        drv.dist_sstep_gmres(laplace3d(8, 8, 8),
                             torch.zeros(512, dtype=torch.float32),
                             comm=SerialComm())


def test_refused_slab_raises(monkeypatch):
    """A slab the polynomial kernel's plan refuses raises: nothing falls
    back to the plain version. The kernel path is taken on the CPU by
    forcing ``use_kernel``, and the plan refused by a shared-memory
    budget no stage fits."""
    monkeypatch.setattr(TP, "use_kernel", lambda x: True)
    monkeypatch.setattr(TP, "MAX_SMEM", 0)
    op = laplace3d(*T.SSTEP_DIMS, dtype=np.float32, fmt="stencil")
    b = torch.from_numpy(T.vectors(op.n_rows, 42).astype(np.float32))
    with pytest.raises(ValueError, match="shared memory"):
        drv.dist_sstep_gmres(op, b, comm=SerialComm(), sigma=12.0,
                             **T.SSTEP_KW)


@pytest.mark.parametrize("rank", [0, R.P - 1])
def test_zslab_owned_rows_agree_either_way(rank):
    """Rank 0's and the last rank's extended slabs, whose depth-3 ghost
    planes lie past the global faces (zero in the extended vector): each
    stage of the monomial basis through the JAX package's Pallas kernel
    (interpret mode: only dz ≠ 0 terms masked), its XLA reference and the
    port (every term masked) — the ghost planes differ, the owned rows
    agree."""
    jop = jlaplace3d(*ZB_GRID, dtype=np.float32, fmt="stencil")
    jds = JD.distribute_stencil(jop, R.P, depth=ZB_STAGES)
    op = laplace3d(*ZB_GRID, dtype=np.float32, fmt="stencil")
    ds = D.distribute_stencil(op, R.P, depth=ZB_STAGES)
    zb = D.zslab_bounds(op, R.P, ZB_STAGES)[rank]
    np.testing.assert_array_equal(
        zb, JD.zslab_bounds(jop, R.P, ZB_STAGES)[rank])
    assert zb[0] > 0 if rank == 0 else zb[1] < ds.op_local.dims[2]
    ext = np.where(ds.valid[rank], T.vectors(ds.op_local.n_rows_pad, 21),
                   0.0).astype(np.float32)
    stages = TP.monomial_stages(ZB_STAGES, 12.0)
    kern = np.asarray(JP.stencil_powers_apply(
        jds.op_local, stages, jnp.asarray(ext), interpret=True,
        z_bounds=jnp.asarray(zb)))
    xla = np.asarray(JP.stencil_powers_xla(
        jds.op_local, stages, jnp.asarray(ext), z_bounds=jnp.asarray(zb)))
    port = TP.stencil_powers_plain(ds.op_local, stages,
                                   torch.from_numpy(ext), tuple(zb)).numpy()
    pxy = ZB_GRID[0] * ZB_GRID[1]
    own = slice(ZB_STAGES * pxy, ZB_STAGES * pxy + ds.row_map.n_local_pad)
    assert np.abs(kern - xla).max() > 0  # the ghost planes differ
    np.testing.assert_array_equal(kern[:, own], xla[:, own])
    np.testing.assert_allclose(port, xla, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(port[:, own], kern[:, own], rtol=1e-6,
                               atol=1e-6)


def test_dist_sstep_entry_matches_single_card(groups):
    """The fixed work of ``sstep_entry`` (160 basis vectors, σ = 12) on 4
    ranks: the same count on every rank and on one card, x within 1e-4
    (float32; at 16³ both residuals sit at float32's floor, so x, not the
    residual norm, is compared)."""
    case = groups[2]["entry/sstep"]
    single = case["ranks"][0]["single"]
    assert set(case["iters"]) == {single["iters"]} == {160}
    rmap = Map.uniform(int(np.prod(T.ENTRY_SMALL["sstep"])), R.P)
    x, want = rmap.from_padded(case["xp"]), single["x"][:rmap.n_global]
    assert np.abs(x - want).max() / np.abs(want).max() <= ENTRY_X_TOL
