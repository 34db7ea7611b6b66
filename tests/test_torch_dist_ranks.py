"""The port's distributed applies in real rank processes, against the JAX
package's distributed applies on its virtual CPU mesh, in float64.

One gloo group of 4 ranks and one of 8 (spawned through
``parallel.driver.launch``, rank bodies in ``torch_dist_tasks``) compute
every case at once; each case below reads the stored results. The JAX
side runs the same matrices and vectors through its ``distribute`` and
``read_sparse_distributed`` and, in one ``shard_map`` program over a mesh
of the same size, through the per-shard applies of its ``dist_spmv`` and
``dist_spmv_t``, ``exchange`` and ``export_combine``.

Tolerance: 1e-12 relative to the largest entry (the boundary rows' sums
may add in another order); the halo plans' exchange mode must be the
JAX package's (ppermute at 4 ranks, all-to-all for the random matrix at
8). The launcher's hang guard and failure report are tested on small
groups of their own.
"""
import multiprocessing
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as PS

from trilinos_tpu.io import matrix_market as jmm
from trilinos_tpu.ops import formats as F
from trilinos_tpu.parallel import distmatrix as JD
from trilinos_tpu.parallel import driver as jdrv
from trilinos_tpu_torch.io import write_sparse
from trilinos_tpu_torch.parallel import driver as drv

import torch_dist_tasks as T

TOL = 1e-12
RANKS = (4, 8)
TIMEOUT = 300.0


def jcsr(a):
    """The JAX package's CsrHost with the port matrix's arrays."""
    return F.CsrHost(a.row_ptr, a.cols, a.vals, a.shape)


def gather(ranks, key):
    return np.concatenate([r[key] for r in ranks])


def _jax_side(p, mtx):
    """Every reference of one group size from ONE shard_map program of the
    JAX package (its per-shard applies, exchange and combine), so its mesh
    compiles once."""
    mesh = jdrv.make_mesh(p)
    probs = T.spmv_problems()
    mats = {name: JD.distribute(jcsr(a), p) for name, a in probs.items()}
    lap = JD.distribute(jcsr(probs["laplace2d"]), p)
    jdr = jmm.read_sparse_distributed(str(mtx), p)
    vecs = {}
    for name, a in probs.items():
        n = a.shape[0]
        for label, x in (("1d", T.vectors(n, 5)),
                         ("k4", T.vectors(n, 6, T.K))):
            vecs[f"{name}/{label}"] = jnp.asarray(
                mats[name].row_map.to_padded(x))
    vecs["combine"] = jnp.asarray(lap.row_map.to_padded(
        T.vectors(probs["laplace2d"].shape[0], 7)))
    vecs["read"] = jnp.asarray(jdr.row_map.to_padded(
        T.vectors(jdr.row_map.n_global, 8)))
    ms = dict(mats, combine=lap, read=jdr)
    spec = {k: (PS(jdrv.AXIS) if v.ndim == 1 else PS(jdrv.AXIS, None))
            for k, v in vecs.items()}

    def body(m_sh, v_sh):
        m = {k: JD.unstack_local(v) for k, v in m_sh.items()}
        out = {}
        for name in probs:
            for label in ("1d", "k4"):
                v = v_sh[f"{name}/{label}"]
                out[f"{name}/spmv/{label}"] = jdrv._local_op(m[name], p)(v)
                out[f"{name}/spmv_t/{label}"] = jdrv._local_op_t(
                    m[name], p)(v)
        x = v_sh["combine"]
        ghosts = JD.exchange(x, m["combine"].plan, jdrv.AXIS, p)
        for mode, scale in T.COMBINE_SCALES.items():
            out[f"combine/{mode}"] = JD.export_combine(
                x, ghosts * scale, m["combine"].plan, jdrv.AXIS, p,
                mode=mode)
        out["read/spmv"] = jdrv._local_op(m["read"], p)(v_sh["read"])
        return out

    out_spec = {**{f"{name}/{op}/{label}": spec[f"{name}/{label}"]
                   for name in probs for op in ("spmv", "spmv_t")
                   for label in ("1d", "k4")},
                **{f"combine/{mode}": spec["combine"]
                   for mode in T.COMBINE_SCALES},
                "read/spmv": spec["read"]}
    run = jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=({k: PS(jdrv.AXIS) for k in ms}, spec),
        out_specs=out_spec))
    want = {k: np.asarray(v) for k, v in run(ms, vecs).items()}
    for name, jdm in mats.items():
        want[f"{name}/mode"] = jdm.plan.mode
    want["read/mode"] = jdr.plan.mode
    return want


def _compute(root):
    mtx = root / "dist_read.mtx"
    write_sparse(mtx, T.nonsym_csr(4, 80))
    port, ref = {}, {}
    for p in RANKS:
        ranks = drv.launch(T.ranks_spmv, p, str(mtx), device="cpu",
                           rendezvous_dir=root, timeout=TIMEOUT)
        ref[p] = _jax_side(p, mtx)
        got = {k: (ranks[0][k] if k.endswith("mode")
                   else gather(ranks, k)) for k in ref[p]}
        got["staged"] = [r["staged"] for r in ranks]
        port[p] = got
    return port, ref


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return T.shared("torch_dist_ranks", lambda: _compute(
        tmp_path_factory.getbasetemp()), tmp_path_factory)


def _close(got, want):
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)
    assert err <= TOL, err


@pytest.mark.parametrize("p", RANKS)
@pytest.mark.parametrize("name", ["laplace2d", "nonsym"])
@pytest.mark.parametrize("op", ["spmv", "spmv_t"])
@pytest.mark.parametrize("label", ["1d", "k4"])
def test_dist_apply_matches_jax(results, p, name, op, label):
    port, ref = results
    key = f"{name}/{op}/{label}"
    _close(port[p][key], ref[p][key])


@pytest.mark.parametrize("p", RANKS)
@pytest.mark.parametrize("name", ["laplace2d", "nonsym"])
def test_exchange_mode_matches_jax(results, p, name):
    port, ref = results
    assert port[p][f"{name}/mode"] == ref[p][f"{name}/mode"]


def test_both_exchange_modes_run(results):
    port, _ = results
    assert port[4]["nonsym/mode"] == "ppermute"
    assert port[8]["nonsym/mode"] == "a2a"


@pytest.mark.parametrize("p", RANKS)
@pytest.mark.parametrize("mode", sorted(T.COMBINE_SCALES))
def test_export_combine_matches_jax(results, p, mode):
    port, ref = results
    _close(port[p][f"combine/{mode}"], ref[p][f"combine/{mode}"])


@pytest.mark.parametrize("p", RANKS)
def test_read_sparse_distributed_matches_jax(results, p):
    port, ref = results
    assert port[p]["read/mode"] == ref[p]["read/mode"]
    _close(port[p]["read/spmv"], ref[p]["read/spmv"])


def test_gloo_moves_cpu_tensors_unstaged(results):
    port, _ = results
    assert all(s == 0 for p in RANKS for s in port[p]["staged"])


def test_launcher_stops_a_mismatched_collective(tmp_path):
    """Rank 0 waits in an all_reduce, rank 1 for a message never sent: the
    launcher raises at its timeout and leaves no process behind."""
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish"):
        drv.launch(T.ranks_mismatch, 2, device="cpu",
                   rendezvous_dir=tmp_path, timeout=8.0)
    assert time.monotonic() - t0 < 60.0
    assert multiprocessing.active_children() == []


def test_launcher_reports_a_failed_rank(tmp_path):
    """A rank whose body raises stops the group; its traceback comes back
    in the launcher's error."""
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        drv.launch(T.ranks_fail_one, 2, device="cpu",
                   rendezvous_dir=tmp_path, timeout=120.0)
    assert multiprocessing.active_children() == []
