"""The port's rank grids (``parallel.comm.ProcessGrid``, ``driver.make_mesh2``
and ``solve_axes``) in real rank processes, against the port's flat group
and the JAX package's two-level ('dcn', 'rows') mesh, in float64 — the
twins of ``tests/test_dist_twolevel.py``.

The group of 8 of ``torch_dist_reference.ranks_port`` lays itself out as a
(2, 4) grid and runs Galeri Laplace2D 16² over the grid and over the flat
group: the grid's layout (outer-major coordinates, one ``ProcessComm`` an
axis whose rank is the coordinate), the refused sizes, ``solve_axes``,
the SpMV and its transpose, CG + Jacobi, GMRES(30) and LSQR. The grid's
results are bitwise the flat group's (the grid reduces over the same group
in the same order); the iterations are the same on every rank and equal
the JAX package's on its (2, 4) mesh (``jax_grid``), x within 1e-8 of its
(LSQR 1e-6), GMRES's x within 1e-6 of a direct solve as in the JAX twin.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from trilinos_tpu_torch.parallel.map import Map

import torch_dist_reference as R
import torch_dist_tasks as T
from torch_threads import one_thread  # noqa: F401  (autouse)

SOLVES = ("cg", "gmres", "lsqr")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return (R.twins(R.ranks_port(tmp_path_factory), "grid"),
            T.shared("torch_dist_grid_jax", R.jax_grid, tmp_path_factory))


def _laplace():
    a = T.laplace2d(*T.GRID_LAPLACE)
    return a, Map.uniform(a.shape[0], 8)


def gathered(ranks, layout, name, key=None):
    parts = [r[layout][name] if key is None else r[layout][name][key]
             for r in ranks]
    return np.concatenate(parts)


def test_grid_layout(results):
    ranks, _ = results
    shape = T.GRID_SHAPE
    for rank, r in enumerate(ranks):
        assert r["index"] == rank
        assert r["coords"] == tuple(int(c) for c in np.unravel_index(
            rank, shape))  # outer-major
        assert r["axis_ranks"] == r["coords"]
        assert r["axis_sizes"] == shape


def test_solve_axes(results):
    ranks, ref = results
    assert ranks[0]["solve_axes"] == (("dcn", "rows"), "rows")
    assert ranks[0]["solve_axes"] == ref["solve_axes"]


def test_grid_size_refused(results):
    ranks, _ = results
    assert "requested 16 grid ranks but only 8 available" in ranks[0][
        "too_many"]
    assert "requested 4 grid ranks" in ranks[0]["too_few"]


@pytest.mark.parametrize("op", ["spmv", "spmv_t"])
def test_apply_on_grid_matches_flat(results, op):
    ranks, _ = results
    got, flat = gathered(ranks, "grid", op), gathered(ranks, "flat", op)
    np.testing.assert_array_equal(got, flat)
    a, rmap = _laplace()
    x = T.vectors(a.shape[0], 20)
    want = a.to_dense() @ x  # Laplace2D is symmetric
    np.testing.assert_allclose(rmap.from_padded(got), want, atol=1e-13)


@pytest.mark.parametrize("name", SOLVES)
def test_solve_on_grid_matches_flat_and_jax(results, name):
    ranks, ref = results
    its = [r["grid"][name]["iters"] for r in ranks]
    assert len(set(its)) == 1, its  # every rank ran the same iterations
    assert its[0] == ranks[0]["flat"][name]["iters"] == ref[name]["iters"]
    assert all(r["grid"][name]["converged"] for r in ranks)
    x = gathered(ranks, "grid", name, "x")
    np.testing.assert_array_equal(x, gathered(ranks, "flat", name, "x"))
    a, rmap = _laplace()
    x = rmap.from_padded(x)
    want = ref[name]["x"]
    err = np.abs(x - want).max() / np.abs(want).max()
    assert err <= (R.LSQR_X_TOL if name == "lsqr" else R.X_TOL), err
    if name == "gmres":
        a_sp = sp.csr_matrix((a.vals, a.cols, a.row_ptr), shape=a.shape)
        x_ref = spla.spsolve(a_sp.tocsc(), T.vectors(a.shape[0], 21))
        np.testing.assert_allclose(x, x_ref, atol=1e-6)
