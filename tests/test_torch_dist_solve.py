"""The port's distributed Krylov solves in real rank processes, against
the JAX package's ``dist_solve`` / ``dist_lsqr`` on its virtual CPU mesh,
in float64: CG unpreconditioned and with ``chebyshev``, GMRES with
``ilu0``, and LSQR.

One gloo group of 4 ranks (spawned through ``parallel.driver.launch``,
rank bodies in ``torch_dist_tasks``) runs every case once a run, with the
s-step cases of ``test_torch_dist_sstep``, and the JAX side runs the same
matrices, right-hand sides and preconditioners on a 4-device mesh
(``torch_dist_reference``); each case reads the stored results. The parity claims are the iteration count (equal, and the same
on every rank) and x, within 1e-8 relative to its largest entry; LSQR
amplifies rounding, and as the JAX package's own test holds its
distributed and serial LSQR to 1e-6, so is this case.
"""
import pytest

import torch_dist_reference as R
import torch_dist_tasks as T
from torch_threads import one_thread  # noqa: F401  (autouse)

CASES = ("cg", "gmres_ilu0", "cg_chebyshev", "lsqr")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return (R.solve_port(tmp_path_factory),
            T.shared("torch_dist_solve_jax", lambda: R.jax_results(CASES),
                     tmp_path_factory))


@pytest.mark.parametrize("case", CASES)
def test_iterations_match_jax(results, case):
    R.check_iterations(*results, case)


@pytest.mark.parametrize("case", CASES)
def test_solution_matches_jax(results, case):
    R.check_solution(*results, case)
