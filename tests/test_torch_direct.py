"""The port's direct solvers against the JAX package's: Amesos2 (sparse LU
and Cholesky), Pliris on one device and the Amesos2Wrapper preconditioner.

Both packages factor the same host matrix (Galeri ``laplace2d``,
``recirc2d``, small dense systems; f64) with the same algorithm compiled in
two libraries, so pivot ties could break differently: solutions are held
to the JAX package's to 1e-12 (max|Δ| / max|x|), not the factors bit for
bit, and ``nnz_factors`` equal on matrices without ties. The port's native
path serves wherever ``g++`` is found (``native_calls``), scipy's ``splu``
only without the library (``python_calls``, forced here by a monkeypatch),
where it agrees with the native solve to 1e-12; a block of right-hand
sides (solved across threads) equals each column's own solve bit for bit.
``dense_solve`` and ``dist_dense_solve`` on one rank against
``jnp.linalg.solve`` to 1e-12; ``DirectPrec`` built by its own
``compute()`` and from the JAX inverse (``convert.direct_prec_from_numpy``)
applies to 1e-12, the three pad cases too.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trilinos_tpu import precond as jprec
from trilinos_tpu.galeri import laplace2d as j_laplace2d
from trilinos_tpu.galeri import recirc2d as j_recirc2d
from trilinos_tpu.ops import formats as JF
from trilinos_tpu.solvers import direct as jdirect
from trilinos_tpu.solvers.pliris import dense_solve as j_dense_solve

from trilinos_tpu_torch import native
from trilinos_tpu_torch import precond as tprec
from trilinos_tpu_torch.convert import direct_prec_from_numpy
from trilinos_tpu_torch.ops import formats as TF
from trilinos_tpu_torch.parallel.comm import SerialComm
from trilinos_tpu_torch.solvers import (NotSpdError, SparseCholesky, SparseLu,
                                        dense_solve, direct_solve,
                                        dist_dense_solve)
from trilinos_tpu_torch.solvers import direct as tdirect
from torch_threads import one_thread  # noqa: F401  (autouse)

TOL = 1e-12
MATRICES = {"laplace2d": j_laplace2d(15, 13),
            "recirc2d": j_recirc2d(12, 12, diff=1e-3)}
ZERO_DIAG = np.array([[0.0, 2.0, 0.0], [1.0, 0.0, 3.0], [0.0, 4.0, 1.0]])


def port_csr(a):
    return TF.CsrHost(a.row_ptr, a.cols, a.vals, a.shape)


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def rhs(n, k=None, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n,) if k is None else (n, k))


@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("k", [None, 3])
def test_sparse_lu_matches_jax(name, k):
    a = MATRICES[name]
    b = rhs(a.shape[0], k)
    before = (SparseLu.native_calls, SparseLu.python_calls)
    lu = SparseLu(port_csr(a)).factor()
    assert (SparseLu.native_calls, SparseLu.python_calls) == (
        before[0] + 1, before[1])
    jlu = jdirect.SparseLu(a).factor()
    x = lu.solve(b)
    assert x.shape == b.shape
    assert rel(x, jlu.solve(b)) <= TOL
    if k is not None:  # a block is each column's own solve, bit for bit
        np.testing.assert_array_equal(x[:, 1], lu.solve(b[:, 1]))
    assert lu.nnz_factors == jlu.nnz_factors > a.nnz
    r = b - a.to_dense() @ x
    assert np.abs(r).max() <= 1e-10 * np.abs(b).max()
    assert rel(direct_solve(port_csr(a), b), x) <= TOL


def test_sparse_lu_pivots_a_zero_diagonal():
    a = JF.CsrHost.from_dense(ZERO_DIAG)
    b = np.array([2.0, 7.0, 9.0])
    x = SparseLu(port_csr(a)).factor().solve(b)
    np.testing.assert_allclose(ZERO_DIAG @ x, b, rtol=TOL, atol=TOL)
    assert rel(x, jdirect.SparseLu(a).factor().solve(b)) <= TOL
    with pytest.raises(ValueError, match="square"):
        SparseLu(TF.CsrHost.from_dense(np.ones((2, 3))))


@pytest.mark.parametrize("k", [None, 3])
def test_sparse_cholesky_matches_jax(k):
    a = MATRICES["laplace2d"]
    b = rhs(a.shape[0], k, seed=2)
    before = SparseCholesky.native_calls
    ch = SparseCholesky(port_csr(a)).factor()
    assert SparseCholesky.native_calls == before + 1
    jch = jdirect.SparseCholesky(a).factor()
    assert rel(ch.solve(b), jch.solve(b)) <= TOL
    assert ch.nnz_factors == jch.nnz_factors
    # LLᵀ has no pivoting: its factor holds less than LU's two
    assert ch.nnz_factors < SparseLu(port_csr(a)).factor().nnz_factors


def test_sparse_cholesky_refuses_a_matrix_not_spd():
    for dense in (np.array([[1.0, 2.0], [2.0, 1.0]]),
                  MATRICES["recirc2d"].to_dense()):
        with pytest.raises(NotSpdError, match="not symmetric positive"):
            SparseCholesky(TF.CsrHost.from_dense(dense)).factor()
    assert issubclass(NotSpdError, ValueError)
    assert NotSpdError is native.NotSpdError


def test_scipy_path_serves_only_without_the_library(monkeypatch):
    a = MATRICES["recirc2d"]
    b = rhs(a.shape[0], 2, seed=4)
    x_native = SparseLu(port_csr(a)).factor().solve(b)
    monkeypatch.setattr(tdirect, "splu_native", lambda *args: None)
    monkeypatch.setattr(tdirect, "spchol_native", lambda *args: None)
    before = (SparseLu.python_calls, SparseCholesky.python_calls)
    lu = SparseLu(port_csr(a)).factor()
    assert lu._scipy is not None and lu.nnz_factors > 0
    assert rel(lu.solve(b), x_native) <= TOL
    lap = MATRICES["laplace2d"]
    ch = SparseCholesky(port_csr(lap)).factor()
    assert ch._fallback is not None
    assert rel(ch.solve(rhs(lap.shape[0])),
               jdirect.SparseCholesky(lap).factor().solve(
                   rhs(lap.shape[0]))) <= TOL
    assert (SparseLu.python_calls, SparseCholesky.python_calls) == (
        before[0] + 2, before[1] + 1)


def test_native_wrappers_without_the_library(monkeypatch):
    monkeypatch.setattr(native, "lib", lambda: None)
    a = port_csr(MATRICES["laplace2d"])
    for fn in (native.splu_native, native.spchol_native):
        assert fn(a.shape[0], a.row_ptr, a.cols, a.vals) is None


@pytest.mark.parametrize("k", [None, 4])
def test_dense_solve_matches_jax(k):
    rng = np.random.default_rng(6)
    a = rng.standard_normal((40, 40)) + 40 * np.eye(40)
    b = rng.standard_normal((40,) if k is None else (40, k))
    got = dense_solve(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = j_dense_solve(jnp.asarray(a), jnp.asarray(b))
    assert rel(got, want) <= TOL
    # the column-block LU on one rank: every panel is the rank's own
    one = dist_dense_solve(SerialComm(), a, b, nb=8, device="cpu").numpy()
    assert one.shape == b.shape
    assert rel(one, want) <= TOL


@pytest.mark.parametrize("solver", ["KLU2", "TACHO", "CHOLMOD"])
def test_direct_prec_matches_jax(solver):
    a = MATRICES["laplace2d"]
    n = a.shape[0]
    npad = JF.round_up(n, JF.ROW_ALIGN)
    jm = jprec.create("AMESOS2", a, {"solver": solver}).compute()
    tm = tprec.create("AMESOS2", port_csr(a), {"solver": solver},
                      device="cpu").compute()
    carried = direct_prec_from_numpy(port_csr(a), np.asarray(jm.inv_dense),
                                     {"solver": solver}, device="cpu")
    assert tm.inv_dense.shape == (npad, npad)
    np.testing.assert_array_equal(tm.inv_dense[n:, n:].numpy(),
                                  np.eye(npad - n))
    assert rel(tm.inv_dense.numpy(), np.asarray(jm.inv_dense)) <= TOL
    # pad cases: as long as the inverse, longer, shorter
    for rows in (npad, npad + 5, n):
        for k in (None, 2):
            r = np.zeros((rows,) if k is None else (rows, k))
            r[:n] = rhs(n, k, seed=7)
            if rows > npad:
                r[npad:] = 1.5
            want = np.asarray(jm(jnp.asarray(r)))
            for m in (tm, carried):
                got = m(torch.from_numpy(r)).numpy()
                assert got.shape == want.shape
                assert rel(got, want) <= TOL
