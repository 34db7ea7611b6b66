"""The port's eigensolves over ranks (``parallel.driver.dist_eigsolve``,
``global_operator``, ``global_precond``) in real rank processes, against
the JAX package's ``dist_eigsolve`` on its virtual CPU mesh, in float64 —
the twins of ``tests/test_dist_eigen.py``, ``tests/test_global_view.py``
(the operator's apply) and ``tests/test_eigen_factory.py``
``test_dist_eigsolve_rejects_mass_for_unsupported``.

LOBPCG (SM, nev 4, Galeri laplace2d 12×10) runs in the group of 4 ranks
and the group of 8 (120 rows: padding at 8), the other cases in the 4-rank
AMG group (``torch_dist_reference.amg_port``): LOBPCG from a given start
against the port's own single-process LOBPCG, block Krylov-Schur (LM,
symmetric), TraceMin, Block Davidson preconditioned by ``dist_jacobi``
through ``global_precond``, RTR (its Ritz residual norms reduced over the
group) and Generalized Davidson (LM on 12 rows a rank, fewer than its
basis limit, which must come from the global row count). Parity:
eigenvalues within 1e-8 of the JAX package's (Generalized Davidson's as
a set: its Schur order follows rounding) and the iterations equal —
LOBPCG's within two: its count here follows the order of the reductions
(the JAX package's own 4- and 8-shard runs take 73 and 77 iterations on
this case, ROADMAP queue 3) — on every rank alike, with the same residual
norms on every rank; the gathered eigenvectors' residuals below 1e-6.
``dist_eigen_entry`` at 16³ (AMG-preconditioned LOBPCG over z-slabs)
against ``eigen_entry`` on one process: the same iterations within two,
eigenvalues within 1e-10 of it and 1e-8 of the closed form.
"""
import numpy as np
import pytest
import torch

from trilinos_tpu_torch.eigen import lobpcg
from trilinos_tpu_torch.galeri import laplace2d
from trilinos_tpu_torch.ops.formats import csr_to_ell
from trilinos_tpu_torch.ops.matvec import spmv
from trilinos_tpu_torch.parallel.map import Map

import torch_dist_reference as R
import torch_dist_tasks as T
from torch_threads import one_thread  # noqa: F401  (autouse)

VAL_RTOL = 1e-8
SERIAL_RTOL = 1e-9
RESID_MAX = 1e-6
APPLY_TOL = 1e-12
ENTRY_RTOL = 1e-10
CLOSED_RTOL = 1e-8
LOBPCG_ITERS_TOL = 2


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return (R.amg_port(tmp_path_factory), R.ranks_port(tmp_path_factory),
            T.shared("torch_dist_eigen_jax", R.jax_eigen, tmp_path_factory))


def _same_on_every_rank(ranks):
    for r in ranks[1:]:
        assert r["iters"] == ranks[0]["iters"]
        np.testing.assert_array_equal(r["vals"], ranks[0]["vals"])
    return ranks[0]


def _gathered_residual(name, ranks):
    grid, nev, _, _ = T.EIGEN_CASES[name]
    a = laplace2d(*grid)
    rmap = Map.uniform(a.shape[0], len(ranks))
    x = rmap.from_padded(np.concatenate([r["vecs"] for r in ranks]))
    lam = np.real(ranks[0]["vals"])[:nev]
    r = a.to_dense() @ x[:, :nev] - x[:, :nev] * lam[None, :]
    return np.linalg.norm(r)


@pytest.mark.parametrize("p", R.RANKS)
def test_lobpcg_matches_jax(results, p):
    _, spmv_groups, ref = results
    ranks = spmv_groups[p]["eigen/lobpcg"]
    got = _same_on_every_rank(ranks)
    want = ref[("lobpcg", p)]
    np.testing.assert_allclose(got["vals"], want["vals"], rtol=VAL_RTOL)
    assert abs(got["iters"] - want["iters"]) <= LOBPCG_ITERS_TOL
    w = np.linalg.eigvalsh(laplace2d(12, 10).to_dense())[:4]
    np.testing.assert_allclose(np.sort(got["vals"]), w, rtol=1e-7)
    assert _gathered_residual("lobpcg", ranks) < RESID_MAX


def test_lobpcg_matches_serial(results):
    """The same start block through one process's LOBPCG: the reductions
    add in another order, so the counts may part by rounding (the JAX
    twin allows 2), the eigenvalues agree to 1e-9."""
    port, _, ref = results
    got = _same_on_every_rank(port["eigen/lobpcg_v0"]["ranks"])
    grid, nev, _, kw = T.EIGEN_CASES["lobpcg_v0"]
    a = laplace2d(*grid)
    dev = csr_to_ell(a, device="cpu")
    v0 = np.zeros((dev.n_rows_pad, nev))
    v0[:a.shape[0]] = T.lobpcg_v0(a.shape[0])
    serial = lobpcg(lambda v: spmv(dev, v), torch.from_numpy(v0), **kw)
    assert abs(got["iters"] - int(serial.iters)) <= 2
    np.testing.assert_allclose(got["vals"], np.asarray(serial.eigenvalues),
                               rtol=SERIAL_RTOL)
    want = ref[("lobpcg_v0", R.P)]
    np.testing.assert_allclose(got["vals"], want["vals"], rtol=VAL_RTOL)
    assert abs(got["iters"] - want["iters"]) <= LOBPCG_ITERS_TOL


@pytest.mark.parametrize("name", ["bks", "tracemin", "davidson", "rtr",
                                  "generalized_davidson"])
def test_eigensolver_matches_jax(results, name):
    port, _, ref = results
    ranks = port[f"eigen/{name}"]["ranks"]
    got = _same_on_every_rank(ranks)
    want = ref[(name, R.P)]
    nev = T.EIGEN_CASES[name][1]
    assert got["converged"]
    # the residual norms that decide convergence are reduced over the
    # group: every rank holds the same ones
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["resnorms"], got["resnorms"])
    got_vals = np.real(got["vals"])[:nev]
    want_vals = np.real(want["vals"])[:nev]
    if name == "generalized_davidson":
        # the wanted set leads the sorted real Schur form, in the order
        # the QR iteration deflates it, which follows rounding
        got_vals, want_vals = np.sort(got_vals), np.sort(want_vals)
    np.testing.assert_allclose(got_vals, want_vals, rtol=VAL_RTOL)
    assert got["iters"] == want["iters"]
    assert _gathered_residual(name, ranks) < RESID_MAX


@pytest.mark.parametrize("label", ["1d", "k4"])
def test_global_operator_apply_matches_jax(results, label):
    port, _, ref = results
    ranks = port["eigen/global_op"]["ranks"]
    n = int(np.prod(T.GLOBAL_OP_GRID))
    got = Map.uniform(n, R.P).from_padded(
        np.concatenate([r[label] for r in ranks]))
    want = ref["global_op"][label]
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= APPLY_TOL, err


def test_mass_matrix_refused_like_jax(results):
    """lanczos_eigs's ``m`` is its basis length: no mass matrix is bound to
    it, in any rank, with the JAX package's message."""
    port, _, ref = results
    msgs = port["eigen/mass_refused"]["ranks"]
    assert ref["mass_refused"] is not None and "mass" in ref["mass_refused"]
    assert msgs == [ref["mass_refused"]] * R.P


def test_dist_eigen_entry_matches_single_card(results):
    port, _, _ = results
    case = port["entry/eigen"]
    got = _same_on_every_rank(case["ranks"])
    single = case["ranks"][0]["single"]
    assert abs(got["iters"] - single["iters"]) <= LOBPCG_ITERS_TOL
    np.testing.assert_allclose(np.sort(got["vals"]), np.sort(single["vals"]),
                               rtol=ENTRY_RTOL)
    n = T.ENTRY_SMALL["eigen"][0]
    lam1 = 2.0 - 2.0 * np.cos(np.arange(1, 3) * np.pi / (n + 1))
    closed = np.sort([lam1[i] + lam1[j] + lam1[k]
                      for i in range(2) for j in range(2)
                      for k in range(2)])[:4]
    np.testing.assert_allclose(np.sort(got["vals"]), closed,
                               rtol=CLOSED_RTOL)
