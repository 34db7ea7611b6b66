"""The port's distributed dense LU (``solvers.pliris.dist_dense_solve``, the
Pliris analogue) in real rank processes, against numpy and the JAX
package's ``dist_dense_solve`` on its 8-device CPU mesh, in float64 — the
twins of ``tests/test_pliris.py``.

The group of 8 of ``torch_dist_reference.ranks_port`` solves each system
(``torch_dist_tasks.pliris_cases``): n 128 with panels of 16 and n 256 with
32, a zero leading diagonal that needs the pivoting, 5 right-hand sides,
and panels as wide as a rank's columns (every panel on another owner).
x is the same on every rank, within 1e-9 of the JAX package's
(``jax_pliris``) and of numpy; the validation messages are the JAX
package's.
"""
import numpy as np
import pytest

import torch_dist_reference as R
import torch_dist_tasks as T
from torch_threads import one_thread  # noqa: F401  (autouse)

TOL = 1e-9


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return (R.twins(R.ranks_port(tmp_path_factory), "pliris"),
            T.shared("torch_dist_pliris_jax", R.jax_pliris,
                     tmp_path_factory))


@pytest.mark.parametrize("name", list(T.PLIRIS_CASES))
def test_dist_dense_solve_matches_numpy_and_jax(results, name):
    ranks, ref = results
    n, _, seed, piv, k = T.PLIRIS_CASES[name]
    a, b = T.pliris_system(n, seed, piv, k)
    x = ranks[0][name]
    assert x.shape == b.shape
    for r in ranks:  # replicated
        np.testing.assert_array_equal(r[name], x)
    np.testing.assert_allclose(x, ref[name], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(x, np.linalg.solve(a, b), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(a @ x, b, atol=1e-8 if piv or k else TOL)


@pytest.mark.parametrize("label,match", [("divisible", "not divisible"),
                                         ("square", "square"),
                                         ("panel", "panel width 3 must "
                                          "divide")])
def test_validation(results, label, match):
    assert match in results[0][0][label]
