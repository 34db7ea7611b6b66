"""The port's structured N-D distributed arrays (``parallel/mdarray.py``,
Domi's MDMap/MDVector) in real rank processes, against numpy and the JAX
package's ``parallel.mdarray`` on its virtual CPU mesh, in float64 — the
twins of ``tests/test_mdarray.py``.

The group of 8 of ``torch_dist_reference.ranks_port`` lays itself out as a
(2, 4) grid (axes x, y) and a (2, 2, 2) one (x, y, z) and runs every case
(``torch_dist_tasks.md_cases``); the JAX side runs the same fields through
``md_map_apply``, ``md_solve`` and ``md_poly_apply`` (``jax_md``).

* Layouts: local shapes, a local axis, the gathered blocks, the refused
  indivisible extent.
* The halo exchange, gathered: the 5-point Laplacian with zero (Dirichlet)
  and periodic edges, the diagonal 9-point sum (corner ghosts), halo width
  2 and a local periodic axis — 1e-13 of numpy and of the JAX package;
  the periodic x axis of size 2 sends both slabs to one neighbour.
* ``md_dot`` to 1e-12; the md CGs on the 2-D grid and the three-axis grid
  (``cg_single_reduce``): the same iterations on every rank and the JAX
  package's, x within 1e-10 of its, residual ≤ 1e-11 against one process.
* The CA sweep (one deep exchange) against chained single applies, both
  periodic and not, and the JAX package's sweep; the halo mismatch; the
  CA-smoothed md CG (fewer iterations than plain CG, the JAX counts).
* ``dist_md_entry`` at 16³ f64 on a (2, 2, 1) grid of the group of 4:
  the JAX package's count and x within 1e-10.
"""
import numpy as np
import pytest

from trilinos_tpu_torch.entry import MD_RTOL

import torch_dist_reference as R
import torch_dist_tasks as T
from torch_threads import one_thread  # noqa: F401  (autouse)

APPLY_TOL = 1e-13
X_TOL = 1e-10


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    port = R.ranks_port(tmp_path_factory)
    return (R.twins(port, "md"), R.twins(port, "md_entry"),
            T.shared("torch_dist_md_jax", R.jax_md, tmp_path_factory))


def _lap5_padded(ap):
    return (4 * ap[1:-1, 1:-1] - ap[:-2, 1:-1] - ap[2:, 1:-1]
            - ap[1:-1, :-2] - ap[1:-1, 2:])


def numpy_apply(name, a):
    """The JAX twin's reference of each apply."""
    if name == "dirichlet":
        return _lap5_padded(np.pad(a, 1))
    if name == "periodic":
        return _lap5_padded(np.pad(a, 1, "wrap"))
    if name == "corner":
        return (np.roll(np.roll(a, 1, 0), 1, 1)
                + np.roll(np.roll(a, -1, 0), -1, 1)
                + np.roll(np.roll(a, 1, 0), -1, 1)
                + np.roll(np.roll(a, -1, 0), 1, 1))
    if name == "halo2":
        return np.roll(a, 2, 0)
    ap = np.pad(a, ((1, 1), (0, 0)))           # zero in x
    return _lap5_padded(np.pad(ap, ((0, 0), (1, 1)), "wrap"))  # periodic y


def rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def test_local_shape_and_gather(results):
    ranks, _, _ = results
    a = np.arange(16 * 32, dtype=np.float64).reshape(16, 32)
    for r in ranks:
        assert r["layout"]["local_shape"] == (8, 8)
        np.testing.assert_array_equal(r["layout"]["gathered"], a)


def test_indivisible_rejected(results):
    assert "not divisible" in results[0][0]["indivisible"]


def test_mixed_local_axis(results):
    assert results[0][0]["layout"]["mixed"] == (8, 8, 3)


@pytest.mark.parametrize("name", list(T.MD_APPLIES))
def test_apply_matches_numpy_and_jax(results, name):
    ranks, _, ref = results
    shape, _, _, _, seed, _ = T.MD_APPLIES[name]
    want = numpy_apply(name, T.md_field(shape, seed))
    for r in ranks:  # the gather is the same on every rank
        np.testing.assert_allclose(r[name], want, atol=APPLY_TOL)
        np.testing.assert_allclose(r[name], ref[name], atol=APPLY_TOL)


def test_md_dot(results):
    ranks, _, ref = results
    rng = np.random.default_rng(5)
    fa, fb = rng.standard_normal((16, 32)), rng.standard_normal((16, 32))
    for r in ranks:
        assert np.isclose(r["md_dot"], np.vdot(fa, fb), rtol=1e-12)
    assert np.isclose(ranks[0]["md_dot"], ref["md_dot"], rtol=1e-12)


def serial_residual(x, b):
    """‖b − A x‖ / ‖b‖ of the Galeri Laplacian (gid = ix + nx·iy…, so the
    field is read in Fortran order, as the JAX twin does)."""
    a = (T.laplace2d(*x.shape) if x.ndim == 2 else T.laplace3d(*x.shape))
    r = b.reshape(-1, order="F") - a.to_dense() @ x.reshape(-1, order="F")
    return np.linalg.norm(r) / np.linalg.norm(b)


def check_solve(parts, ref):
    """One md solve's result on every rank against the JAX package's:
    the same iterations everywhere and the JAX count, converged, the same
    gathered x everywhere and within X_TOL of the JAX x; returns x."""
    its = [q["iters"] for q in parts]
    assert len(set(its)) == 1, its  # every rank ran the same iterations
    assert its[0] == ref["iters"]
    assert all(q["converged"] for q in parts)
    for q in parts:
        np.testing.assert_array_equal(q["x"], parts[0]["x"])
    err = rel(parts[0]["x"], ref["x"])
    assert err <= X_TOL, err
    return parts[0]["x"]


@pytest.mark.parametrize("label,seed", [("cg_2d", 7), ("cg_3d", 8)])
def test_md_cg_matches_serial_and_jax(results, label, seed):
    ranks, _, ref = results
    x = check_solve([r[label] for r in ranks], ref[label])
    assert serial_residual(x, T.md_field(x.shape, seed)) < 1e-11


@pytest.mark.parametrize("periodic", [False, True])
def test_matches_chained_applies(results, periodic):
    ranks, _, ref = results
    case = ranks[0][f"chained/{periodic}"]
    np.testing.assert_allclose(case["poly"], case["chained"], atol=1e-12)
    np.testing.assert_allclose(case["poly"], ref[f"chained/{periodic}"],
                               atol=APPLY_TOL)


def test_halo_mismatch_rejected(results):
    assert "halo" in results[0][0]["halo_mismatch"]


def test_prec_and_prec_local_refused(results):
    assert "not both" in results[0][0]["both_precs"]


def test_ca_smoothed_md_cg(results):
    ranks, _, ref = results
    x = check_solve([r["ca_cg"] for r in ranks], ref["ca_cg"])
    check_solve([r["ca_cg_plain"] for r in ranks], ref["ca_cg_plain"])
    assert ranks[0]["ca_cg"]["iters"] < ranks[0]["ca_cg_plain"]["iters"]
    assert serial_residual(x, T.md_field(x.shape, 12)) < 1e-10


def test_md_entry_matches_jax(results):
    _, ranks, ref = results
    assert [r["coords"] for r in ranks] == [(0, 0, 0), (0, 1, 0), (1, 0, 0),
                                            (1, 1, 0)]
    x = check_solve(ranks, ref["md_entry"])
    b = np.random.default_rng(0).standard_normal(T.MD_ENTRY_DIMS)
    np.testing.assert_array_equal(ranks[0]["b"], b)
    assert serial_residual(x, b) <= MD_RTOL
