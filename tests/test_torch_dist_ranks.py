"""The port's distributed applies in real rank processes, against the JAX
package's distributed applies on its virtual CPU mesh, in float64.

One gloo group of 4 ranks and one of 8 (spawned through
``parallel.driver.launch``, rank bodies in ``torch_dist_tasks``) compute
every case at once, once a run (``torch_dist_reference.ranks_port``, which
``test_torch_dist_schwarz`` and ``test_torch_dist_eigen`` read too); each
case below reads the stored results. The JAX side runs the same matrices
and vectors through its ``distribute`` and ``read_sparse_distributed``
and, in one ``shard_map`` program over a mesh of the same size, through
the per-shard applies of its ``dist_spmv`` and ``dist_spmv_t``,
``exchange`` and ``export_combine`` (``torch_dist_reference.ranks_jax``).

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

from trilinos_tpu_torch.parallel import driver as drv

import torch_dist_reference as R
import torch_dist_tasks as T
from torch_threads import one_thread  # noqa: F401  (autouse)

TOL = 1e-12
RANKS = R.RANKS


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return R.ranks_port(tmp_path_factory), R.ranks_jax(tmp_path_factory)


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
