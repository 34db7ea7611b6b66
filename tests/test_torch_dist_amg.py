"""The port's distributed AMG and smoother paths in real rank processes,
against the JAX package's ``dist_solve`` on its virtual CPU mesh, in
float64: CG with ``dist_amg`` (host set-up), ``dist_amg_blocks``
(distributed set-up) and ``dist_cheb_fused`` (per-rank z-bounds), and the
two distributed entries at small sizes — ``dist_pipelined_cg_entry`` on
8³ (pipelined CG with ``jacobi``) and ``dist_amg_entry`` on 16³ in
float64 (CG with ``amg_structured``).

One gloo group of 4 ranks (rank bodies in ``torch_dist_tasks``) runs
every case once a run, with the eigensolver, Schwarz and entry cases of
``test_torch_dist_eigen``, ``test_torch_dist_schwarz`` and
``test_torch_dist_sstep``; the JAX side (``torch_dist_reference``) runs
the same problems on a 4-device mesh. Parity: equal iterations on every rank
and x within 1e-8 relative to its largest entry; the entries' right-hand
sides are the JAX twins' bit for bit.
"""
import numpy as np
import pytest

import torch_dist_reference as R
import torch_dist_tasks as T
from torch_threads import one_thread  # noqa: F401  (autouse)

CASES = ("cg_amg", "cg_amg_blocks", "cg_cheb_fused", "entry/pipelined_cg",
         "entry/amg")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return (R.amg_port(tmp_path_factory),
            T.shared("torch_dist_amg_jax", lambda: R.jax_results(CASES),
                     tmp_path_factory))


@pytest.mark.parametrize("case", CASES)
def test_iterations_match_jax(results, case):
    R.check_iterations(*results, case)


@pytest.mark.parametrize("case", CASES)
def test_solution_matches_jax(results, case):
    R.check_solution(*results, case)


@pytest.mark.parametrize("case", ["entry/pipelined_cg", "entry/amg"])
def test_entry_rhs_is_the_jax_twin(results, case):
    port, ref = results
    np.testing.assert_array_equal(
        R.row_map(case).from_padded(port[case]["bp"]), ref[case]["b"])
