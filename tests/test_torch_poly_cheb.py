"""The port's stored-matrix Chebyshev and GMRES-polynomial preconditioners
against the JAX package's.

Both packages take the same host matrix (Galeri ``laplace2d``,
``laplace3d`` and ``recirc2d``, f64). Chebyshev: λmax from the seeded
power method over every padded entry, and λmin = λmax / ratio, to 1e-12
relative; the apply on one vector and on a block to 1e-12 (max|Δ| /
max|y|). GmresPoly: H and y of the set-up to 1e-12 (the port's CGS2 takes
each pass's coefficients as one GEMV, the reference one dot at a time),
the degree reached (also at an Arnoldi breakdown), and the apply to
1e-12; a polynomial carried over from the JAX package
(``convert.gmres_poly_from_numpy``) applies as the JAX one does.
``precond.create`` builds both under the reference's names.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trilinos_tpu import precond as jprec
from trilinos_tpu.galeri import laplace2d as j_laplace2d
from trilinos_tpu.galeri import laplace3d as j_laplace3d
from trilinos_tpu.galeri import recirc2d as j_recirc2d
from trilinos_tpu.ops import choose_format as j_choose_format
from trilinos_tpu.ops import spmv as j_spmv
from trilinos_tpu.precond.poly import gmres_poly_apply as j_poly_apply
from trilinos_tpu.precond.poly import gmres_poly_setup as j_poly_setup

from trilinos_tpu_torch import precond as tprec
from trilinos_tpu_torch.convert import gmres_poly_from_numpy
from trilinos_tpu_torch.ops import formats as TF
from trilinos_tpu_torch.ops import spmv as t_spmv
from trilinos_tpu_torch.precond.poly import (gmres_poly_apply,
                                             gmres_poly_op,
                                             gmres_poly_setup)
from torch_threads import one_thread  # noqa: F401  (autouse)

TOL = 1e-12
MATRICES = {"laplace2d": j_laplace2d(14, 14),
            "laplace3d": j_laplace3d(8, 8, 8),
            "recirc2d": j_recirc2d(12, 12, diff=0.1)}


def port_csr(a):
    return TF.CsrHost(a.row_ptr, a.cols, a.vals, a.shape)


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def vec(npad, n, k=None, seed=1):
    v = np.zeros((npad,) if k is None else (npad, k))
    v[:n] = np.random.default_rng(seed).standard_normal(v[:n].shape)
    return v


@pytest.mark.parametrize("name,params", [
    ("laplace2d", {"chebyshev: degree": 3}),
    ("laplace3d", {"chebyshev: degree": 4,
                   "chebyshev: eigenvalue max iterations": 25}),
    ("laplace2d", {"chebyshev: degree": 2, "chebyshev: max eigenvalue": 2.1,
                   "chebyshev: min eigenvalue": 0.3})])
def test_chebyshev_matches_jax(name, params):
    a = MATRICES[name]
    jm = jprec.create("CHEBYSHEV", a, dict(params)).compute()
    tm = tprec.create("CHEBYSHEV", port_csr(a), dict(params),
                      device="cpu").compute()
    assert isinstance(tm, tprec.Chebyshev)
    assert abs(tm.lmax - jm.lmax) <= TOL * jm.lmax
    assert abs(tm.lmin - jm.lmin) <= TOL * jm.lmin
    assert tm.degree == jm.degree == params["chebyshev: degree"]
    npad = tm.dinv.shape[0]
    assert npad == jm.dinv.shape[0]
    for k in (None, 3):
        r = vec(npad, a.shape[0], k)
        assert rel(tm(torch.from_numpy(r)).numpy(),
                   jm.apply(jnp.asarray(r))) <= TOL


def test_chebyshev_power_method_estimate():
    """λmax of D⁻¹A for laplace2d lies below 2 (Gershgorin) and the boosted
    estimate near it; λmin is λmax / 30."""
    tm = tprec.Chebyshev(port_csr(MATRICES["laplace2d"]),
                         {"chebyshev: eigenvalue max iterations": 40},
                         device="cpu").compute()
    lam = np.linalg.eigvals(np.diag(1 / MATRICES["laplace2d"].diagonal())
                            @ MATRICES["laplace2d"].to_dense()).real.max()
    assert 0.9 * lam <= tm.lmax / 1.1 <= lam * (1 + 1e-12)
    assert tm.lmin == pytest.approx(tm.lmax / 30.0, rel=1e-15)


@pytest.mark.parametrize("name,degree", [("recirc2d", 10),
                                         ("laplace2d", 6),
                                         ("laplace3d", 10)])
def test_gmres_poly_setup_and_apply_match_jax(name, degree):
    a = MATRICES[name]
    jdev = j_choose_format(a)
    tdev = TF.choose_format(port_csr(a), device="cpu")
    npad, n = tdev.n_rows_pad, a.shape[0]
    v0 = vec(npad, n, seed=2)
    jh, jy, jd = j_poly_setup(lambda v: j_spmv(jdev, v), jnp.asarray(v0),
                              degree)
    th, ty, td = gmres_poly_setup(lambda v: t_spmv(tdev, v),
                                  torch.from_numpy(v0), degree)
    assert td == jd == degree
    assert np.abs(th - jh).max() <= TOL * np.abs(jh).max()
    assert np.abs(ty - jy).max() <= TOL * np.abs(jy).max()
    for k in (None, 2):
        r = vec(npad, n, k, seed=3)
        want = j_poly_apply(lambda v: j_spmv(jdev, v), jh, jy, jd,
                            jnp.asarray(r))
        got = gmres_poly_apply(lambda v: t_spmv(tdev, v), th, ty, td,
                               torch.from_numpy(r))
        assert rel(got.numpy(), want) <= TOL
    apply = gmres_poly_op(lambda v: t_spmv(tdev, v), torch.from_numpy(v0),
                          degree)
    assert rel(apply(torch.from_numpy(r)).numpy(), want) <= TOL


def test_gmres_poly_breakdown_degree_matches_jax():
    """On a 3×3 grid (9 unknowns) the Arnoldi process breaks down before
    degree 15; both stop at the same degree."""
    a = j_laplace2d(3, 3)
    dense = a.to_dense()
    v0 = np.random.default_rng(4).standard_normal(9)
    jh, jy, jd = j_poly_setup(lambda v: jnp.asarray(dense) @ v,
                              jnp.asarray(v0), 15)
    th, ty, td = gmres_poly_setup(lambda v: torch.from_numpy(dense) @ v,
                                  torch.from_numpy(v0), 15)
    assert td == jd < 15
    assert th.shape == jh.shape and ty.shape == jy.shape
    assert np.abs(th - jh).max() <= 1e-10 * np.abs(jh).max()


@pytest.mark.parametrize("key", ["GMRESPOLY", "POLY"])
def test_gmres_poly_class_matches_jax(key):
    a = MATRICES["recirc2d"]
    params = {"poly: degree": 8, "poly: seed": 3}
    jm = jprec.create(key, a, dict(params)).compute()
    tm = tprec.create(key, port_csr(a), dict(params), device="cpu").compute()
    assert isinstance(tm, tprec.GmresPoly)
    assert tm.degree == jm.degree == 8
    assert np.abs(tm.h - jm.h).max() <= TOL * np.abs(jm.h).max()
    assert np.abs(tm.y - jm.y).max() <= TOL * np.abs(jm.y).max()
    r = vec(tm._dev.n_rows_pad, a.shape[0], seed=5)
    want = jm.apply(jnp.asarray(r))
    assert rel(tm(torch.from_numpy(r)).numpy(), want) <= TOL
    # the JAX package's polynomial carried into the port
    cm = gmres_poly_from_numpy(port_csr(a), np.asarray(jm.h),
                               np.asarray(jm.y), jm.degree, device="cpu")
    assert rel(cm(torch.from_numpy(r)).numpy(), want) <= TOL


def test_create_builds_the_ported_names():
    a = port_csr(MATRICES["laplace2d"])
    for key, cls in (("CHEBYSHEV", tprec.Chebyshev),
                     ("gmrespoly", tprec.GmresPoly),
                     ("Poly", tprec.GmresPoly)):
        assert type(tprec.create(key, a, device="cpu")) is cls
    with pytest.raises(TypeError, match="CsrHost"):
        tprec.Chebyshev(np.eye(4), device="cpu").compute()
