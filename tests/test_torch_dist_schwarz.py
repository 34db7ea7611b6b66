"""The port's distributed Schwarz (``parallel.driver.dist_schwarz``, the
``schwarz`` DistPrecond kind) in real rank processes, against the JAX
package's ``dist_schwarz`` on its virtual CPU mesh, in float64 — the twins
of ``tests/test_dist_precond.py`` ``TestDistSchwarz``.

* The applies, restricted (ZERO) and classical (ADD), 1-D and k = 4, on
  Galeri Laplace3D 10×10×8 with overlap 1, in the group of 4 ranks and the
  group of 8 (``torch_dist_reference.ranks_port``) against the same
  applies inside the JAX package's ``shard_map`` program
  (``ranks_jax``): 1e-12 relative to the largest entry.
* GMRES(30) with restricted Schwarz through ``dist_schwarz_entry`` on
  that grid (4 ranks, ``amg_port``) against the JAX package's
  ``dist_solve``: the same iterations on every rank and the JAX count, x
  within 1e-8 relative to its largest entry, true residual ≤ 2e-8 (the
  JAX twin's gate), and the entry's right-hand side bit for bit the
  reference's.
* The host set-up against the JAX package's, shard by shard, through
  ``convert.dist_local_from_jax``'s ``schwarz`` case: every factor, the
  overlap plan and the constants equal.
"""
import numpy as np
import pytest
import torch

import jax

from trilinos_tpu.parallel import distmatrix as JD
from trilinos_tpu.parallel import driver as jdrv
from trilinos_tpu_torch.convert import dist_local_from_jax
from trilinos_tpu_torch.parallel import distmatrix as D
from trilinos_tpu_torch.parallel import driver as drv
from trilinos_tpu_torch.parallel.map import Map

import torch_dist_reference as R
import torch_dist_tasks as T
from torch_threads import one_thread  # noqa: F401  (autouse)

TOL = 1e-12
X_TOL = 1e-8
TRUE_MAX = 2e-8  # tests/test_dist_precond.py test_schwarz_gmres_laplace3d


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return (R.ranks_port(tmp_path_factory), R.ranks_jax(tmp_path_factory),
            R.amg_port(tmp_path_factory),
            T.shared("torch_dist_schwarz_jax", R.jax_schwarz_gmres,
                     tmp_path_factory))


@pytest.fixture(scope="module")
def applies(results):
    return results[:2]


@pytest.fixture(scope="module")
def solve(results):
    return results[2]["schwarz/gmres"], results[3]


@pytest.mark.parametrize("p", R.RANKS)
@pytest.mark.parametrize("mode", T.SCHWARZ_MODES)
@pytest.mark.parametrize("label", ["1d", "k4"])
def test_schwarz_apply_matches_jax(applies, p, mode, label):
    port, ref = applies
    key = f"schwarz/{mode}/{label}"
    got, want = port[p][key], np.asarray(ref[p][key], np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= TOL, err


@pytest.mark.parametrize("p", R.RANKS)
def test_restricted_and_classical_differ(applies, p):
    """ADD exports the overlap rows' contributions back to their owners:
    it changes the owned rows next to every cut, ZERO leaves them."""
    port, _ = applies
    for label in ("1d", "k4"):
        assert not np.allclose(port[p][f"schwarz/ZERO/{label}"],
                               port[p][f"schwarz/ADD/{label}"])


def test_schwarz_gmres_iterations_match_jax(solve):
    port, ref = solve
    its = port["iters"]
    assert len(set(its)) == 1, its  # every rank ran the same iterations
    assert its[0] == ref["iters"]
    assert all(port["converged"])


def test_schwarz_gmres_solution_matches_jax(solve):
    port, ref = solve
    rmap = Map.uniform(len(ref["x"]), R.P)
    x = rmap.from_padded(port["xp"])
    err = np.abs(x - ref["x"]).max() / np.abs(ref["x"]).max()
    assert err <= X_TOL, err
    np.testing.assert_array_equal(rmap.from_padded(port["bp"]), ref["b"])
    a = T.laplace3d(*T.SCHWARZ_DIMS)
    rel = (np.linalg.norm(ref["b"] - a.to_dense() @ x)
           / np.linalg.norm(ref["b"]))
    assert rel <= TRUE_MAX, rel


@pytest.mark.parametrize("mode", T.SCHWARZ_MODES)
def test_setup_matches_jax_shard_by_shard(mode):
    """Every rank's factors, overlap plan and constants from the port's
    host set-up equal the JAX package's shard, converted by
    ``dist_local_from_jax``."""
    a = T.laplace3d(*T.SCHWARZ_DIMS)
    dm = D.distribute(a, R.P)
    pc = drv.dist_schwarz(a, dm.row_map, overlap=1, combine=mode)
    ja = R.jcsr(a)
    jpc = jdrv.dist_schwarz(ja, JD.distribute(ja, R.P).row_map, overlap=1,
                            combine=mode)
    jpc = jax.tree_util.tree_map(np.asarray, jpc)
    for s in range(R.P):
        mine, conv = pc.local(s, "cpu"), dist_local_from_jax(jpc, s, "cpu")
        assert mine.kind == conv.kind == "schwarz"
        assert mine.consts == conv.consts == (6, mode, dm.row_map.n_local_pad)
        for key in ("l_cols", "l_vals", "u_cols", "u_vals", "udinv"):
            assert torch.equal(mine.local[key], conv.local[key]), (s, key)
        for field in ("send_idx", "send_valid", "recv_sel", "ghost_valid"):
            assert torch.equal(getattr(mine.local["plan"], field),
                               getattr(conv.local["plan"], field)), field
        for field in ("n_ghost_pad", "seg", "mode", "offsets"):
            assert (getattr(mine.local["plan"], field)
                    == getattr(conv.local["plan"], field)), field
