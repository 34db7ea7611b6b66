"""The port's block relaxation (every container), multicolor Gauss-Seidel,
additive Schwarz and Hiptmair against the JAX package's.

Both packages take the same host matrix (Galeri ``laplace2d``,
``recirc2d``, ``maxwell2d``, f64) and the same parameters: the set-up's
arrays equal the reference's (the block inverses exactly, though the port
extracts the diagonal blocks vectorized; the colours and the Schwarz
gather, weight and subdomain inverses exactly), and applies on one vector
and on a block agree to 1e-12 (max|Δ| / max|y|), also from the JAX
package's Schwarz arrays carried over by ``convert.schwarz_from_numpy``.
The TriDi container's inverted tridiagonal blocks apply as the
reference's batched tridiagonal solve and equal the Dense container on
line blocks; CG
preconditioned by each container, by symmetric Gauss-Seidel and by
Hiptmair converges in the port.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trilinos_tpu import precond as jprec
from trilinos_tpu.galeri import laplace2d as j_laplace2d
from trilinos_tpu.galeri import recirc2d as j_recirc2d
from trilinos_tpu.galeri.stencils import maxwell2d as j_maxwell2d

from trilinos_tpu_torch import precond as tprec
from trilinos_tpu_torch.convert import schwarz_from_numpy
from trilinos_tpu_torch.ops import choose_format, spmv
from trilinos_tpu_torch.ops import formats as TF
from trilinos_tpu_torch.solvers import cg, gmres
from torch_threads import one_thread  # noqa: F401  (autouse)

TOL = 1e-12
MATRICES = {"laplace2d": j_laplace2d(16, 12),
            "recirc2d": j_recirc2d(12, 10, diff=1e-2)}


def port_csr(a):
    return TF.CsrHost(a.row_ptr, a.cols, a.vals, a.shape)


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def vec(npad, n, k=None, seed=1):
    v = np.zeros((npad,) if k is None else (npad, k))
    v[:n] = np.random.default_rng(seed).standard_normal(v[:n].shape)
    return v


def applies_match(jm, tm, npad, n, tol=TOL):
    for k in (None, 3):
        r = vec(npad, n, k)
        assert rel(tm(torch.from_numpy(r)).numpy(),
                   jm.apply(jnp.asarray(r))) <= tol


def port_cg(a, m, rtol=1e-8):
    dev = choose_format(port_csr(a), device="cpu")
    b = torch.from_numpy(vec(dev.n_rows_pad, a.shape[0], seed=3))
    res = cg(lambda v: spmv(dev, v), b, prec=m, rtol=rtol, maxiter=1000)
    dense = a.to_dense()
    x = res.x.numpy()[:a.shape[0]]
    true = (np.linalg.norm(b.numpy()[:a.shape[0]] - dense @ x)
            / np.linalg.norm(b.numpy()[:a.shape[0]]))
    return res, true


CONTAINER_CASES = [
    ("BLOCK RELAXATION", "laplace2d", {"relaxation: container": "Dense",
                                       "partitioner: block size": 16,
                                       "relaxation: damping factor": 0.9}),
    ("BLOCK RELAXATION", "recirc2d", {"relaxation: container": "Dense",
                                      "partitioner: block size": 5,
                                      "relaxation: sweeps": 3,
                                      "relaxation: damping factor": 0.8}),
    ("TRIDI", "laplace2d", {"relaxation: container": "TriDi",
                            "partitioner: block size": 16}),
    ("TRIDI", "recirc2d", {"relaxation: container": "TriDi",
                           "partitioner: block size": 7,
                           "relaxation: sweeps": 2}),
    ("BANDED RELAXATION", "recirc2d", {"relaxation: container": "Banded",
                                       "partitioner: block size": 12,
                                       "banded: bandwidth": 2}),
    ("BLOCK RELAXATION", "laplace2d", {"relaxation: container": "SparseILU0",
                                       "partitioner: block size": 16}),
    ("DATABASE SCHWARZ", "laplace2d", {"relaxation: container": "Database",
                                       "partitioner: block size": 16}),
]


@pytest.mark.parametrize("name,mat,params", CONTAINER_CASES)
def test_block_relaxation_matches_jax(name, mat, params):
    a = MATRICES[mat]
    jm = jprec.create(name, a, dict(params)).compute()
    tm = tprec.create(name, port_csr(a), dict(params), device="cpu").compute()
    assert isinstance(tm, tprec.BlockRelaxation)
    assert tm.n_pad == jm.n_pad
    container = params["relaxation: container"]
    if container in ("Dense", "Banded"):
        np.testing.assert_array_equal(tm.inv_blocks.numpy(),
                                      np.asarray(jm.inv_blocks))
    if container == "Database":
        assert tm.n_patches == jm.n_patches < jm.n_pad // 16
        np.testing.assert_array_equal(tm.inv_unique.numpy(),
                                      np.asarray(jm.inv_unique))
        np.testing.assert_array_equal(tm.patch_idx.numpy(),
                                      np.asarray(jm.patch_idx))
    applies_match(jm, tm, TF.round_up(a.shape[0], TF.ROW_ALIGN), a.shape[0])
    if mat == "laplace2d":
        res, true = port_cg(a, tm)
        assert bool(res.converged) and true <= 2e-8


def test_tridi_equals_dense_on_line_blocks():
    a = port_csr(j_laplace2d(16, 8))
    common = {"partitioner: block size": 16}
    pd = tprec.create("BLOCK RELAXATION", a, {
        **common, "relaxation: container": "Dense"}, device="cpu").compute()
    pt = tprec.create("TRIDI", a, {**common, "relaxation: container": "TriDi"},
                      device="cpu").compute()
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(128))
    np.testing.assert_allclose(pd(r).numpy(), pt(r).numpy(), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("mat,params", [
    ("laplace2d", {}),
    ("laplace2d", {"relaxation: symmetric": True, "relaxation: sweeps": 2}),
    ("recirc2d", {"relaxation: damping factor": 0.9, "relaxation: sweeps": 3}),
])
def test_multicolor_gauss_seidel_matches_jax(mat, params):
    a = MATRICES[mat]
    jm = jprec.create("MT GAUSS-SEIDEL", a, dict(params)).compute()
    tm = tprec.create("GAUSS-SEIDEL", port_csr(a), dict(params),
                      device="cpu").compute()
    assert isinstance(tm, tprec.MulticolorGaussSeidel)
    np.testing.assert_array_equal(tm.colors, jm.colors)
    assert tm.n_colors == jm.n_colors == (2 if mat == "laplace2d" else
                                          tm.n_colors)
    applies_match(jm, tm, tm.dinv.shape[0], a.shape[0])
    rows = np.repeat(np.arange(a.shape[0]), a.row_lengths())
    off = rows != a.cols
    assert (tm.colors[rows[off]] != tm.colors[a.cols[off]]).all()
    if params.get("relaxation: symmetric"):
        res, true = port_cg(a, tm, rtol=1e-9)
        assert bool(res.converged) and true <= 1.1e-9


SCHWARZ_CASES = [
    ("SCHWARZ", "recirc2d", {"schwarz: num subdomains": 4}),
    ("ADDITIVE SCHWARZ", "recirc2d", {"schwarz: num subdomains": 5,
                                      "schwarz: combine mode": "add",
                                      "schwarz: overlap level": 2}),
    ("SCHWARZ", "laplace2d", {"schwarz: num subdomains": 3,
                              "schwarz: overlap level": 0}),
    ("SCHWARZ", "laplace2d", {"schwarz: num subdomains": 3,
                              "schwarz: subdomain ids": "stripes"}),
]


@pytest.mark.parametrize("name,mat,params", SCHWARZ_CASES)
def test_schwarz_matches_jax(name, mat, params):
    a = MATRICES[mat]
    params = dict(params)
    if params.get("schwarz: subdomain ids") == "stripes":
        params["schwarz: subdomain ids"] = np.arange(a.shape[0]) % 3
    jm = jprec.create(name, a, dict(params)).compute()
    tm = tprec.create(name, port_csr(a), dict(params), device="cpu").compute()
    assert isinstance(tm, tprec.AdditiveSchwarz)
    np.testing.assert_array_equal(tm.gather.numpy(), np.asarray(jm.gather))
    np.testing.assert_array_equal(tm.weight.numpy(), np.asarray(jm.weight))
    np.testing.assert_array_equal(tm.inv.numpy(), np.asarray(jm.inv))
    npad = TF.round_up(a.shape[0], TF.ROW_ALIGN)
    applies_match(jm, tm, npad, a.shape[0])
    cm = schwarz_from_numpy(port_csr(a), np.asarray(jm.inv),
                            np.asarray(jm.gather), np.asarray(jm.weight),
                            dict(params), device="cpu")
    applies_match(jm, cm, npad, a.shape[0])


def test_schwarz_refuses_bad_subdomain_ids():
    a = port_csr(MATRICES["laplace2d"])
    with pytest.raises(ValueError, match="subdomain ids"):
        tprec.create("SCHWARZ", a, {"schwarz: num subdomains": 2,
                                    "schwarz: subdomain ids": np.full(
                                        a.shape[0], 2)},
                     device="cpu").compute()


def edge_problem(nx, ny, sigma):
    return j_maxwell2d(nx, ny, sigma=sigma)


@pytest.mark.parametrize("params", [
    {}, {"hiptmair: aux preconditioner": "SA-AMG",
         "hiptmair: smoother sweeps": 1}])
def test_hiptmair_matches_jax(params):
    a, g = edge_problem(6, 5, 0.1)
    jm = jprec.create("HIPTMAIR", a, dict(params), aux_op=g).compute()
    tm = tprec.create("HIPTMAIR", port_csr(a), dict(params),
                      aux_op=port_csr(g), device="cpu").compute()
    assert isinstance(tm, tprec.Hiptmair)
    assert isinstance(tm.d_dev, TF.EllMatrix)
    npad = tm.dinv_e.shape[0]
    applies_match(jm, tm, npad, a.shape[0])
    r1, r2 = (torch.from_numpy(vec(npad, a.shape[0], seed=s)) for s in (3, 4))
    assert abs(float(tm(r1) @ r2) - float(r1 @ tm(r2))) <= 1e-10 * abs(
        float(tm(r1) @ r2))


def test_hiptmair_beats_jacobi_on_curl_curl():
    n_e = 10 * 9 + 11 * 8
    sigma = 10.0 ** np.random.default_rng(9).uniform(-3, 0, n_e)
    a, g = edge_problem(10, 8, sigma)
    hip = tprec.create("HIPTMAIR", port_csr(a),
                       {"hiptmair: aux preconditioner": "SA-AMG"},
                       aux_op=port_csr(g), device="cpu").compute()
    jac = tprec.create("JACOBI", port_csr(a), device="cpu").compute()
    r_h, true = port_cg(a, hip)
    r_j, _ = port_cg(a, jac)
    assert bool(r_h.converged) and true <= 2e-8
    assert int(r_h.iters) < 0.6 * int(r_j.iters)
    with pytest.raises(ValueError, match="aux_op"):
        tprec.create("HIPTMAIR", port_csr(a), device="cpu").compute()


def test_every_new_name_preconditions_gmres():
    """Each name of this module's classes (and the ILU family) through
    ``create`` converges GMRES(30) on the nonsymmetric recirc2d."""
    a = MATRICES["recirc2d"]
    dev = choose_format(port_csr(a), device="cpu")
    b = torch.from_numpy(vec(dev.n_rows_pad, a.shape[0], seed=5))
    for name, params in [("RILUK", {}), ("ILUT", {}),
                         ("BLOCK RELAXATION", {}), ("MT GAUSS-SEIDEL", {}),
                         ("SCHWARZ", {}), ("ADDITIVE SCHWARZ",
                                       {"schwarz: combine mode": "add"})]:
        m = tprec.create(name, port_csr(a), params, device="cpu").compute()
        res = gmres(lambda v: spmv(dev, v), b, prec=m, restart=30,
                    rtol=1e-8, maxiter=1000)
        assert bool(torch.as_tensor(res.converged).all()), name
