"""The port's incomplete factorizations against the JAX package's: ILU(k)
(RILUK), RBILUK and ILUT, their native C++ and Python paths, and their
fixed-sweep applies.

Both packages take the same host matrix (Galeri ``recirc2d``,
``laplace2d``, ``elasticity2d``, f64). The factors, the level-of-fill
pattern and the augmented patterns must be the reference's exactly (row
pointers, columns and values), the port's native path must equal its
Python path, and each path must equal the same path of the JAX package
(whose own native library serves its fast path). Applies on one vector and
on a block agree to 1e-12 (max|Δ| / max|y|), also from the JAX package's
factors carried over by ``convert.ilu_from_numpy``; the factors of a
five-point matrix pack as DIA. Without the library each function counts a
Python call.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import jax
import jax.numpy as jnp

import trilinos_tpu.native as jnative
from trilinos_tpu import precond as jprec
from trilinos_tpu.galeri import elasticity2d as j_elasticity2d
from trilinos_tpu.galeri import laplace1d as j_laplace1d
from trilinos_tpu.galeri import laplace2d as j_laplace2d
from trilinos_tpu.galeri import recirc2d as j_recirc2d
from trilinos_tpu.precond import ilu as jilu
from trilinos_tpu.precond import ilut as jilut

from trilinos_tpu_torch import precond as tprec
from trilinos_tpu_torch.convert import ilu_from_numpy
from trilinos_tpu_torch.ops import formats as TF
from trilinos_tpu_torch.precond import ilu as tilu
from trilinos_tpu_torch.precond import ilut as tilut
from torch_threads import one_thread  # noqa: F401  (autouse)

TOL = 1e-12
MATRICES = {"recirc2d": j_recirc2d(10, 10, diff=1e-2),
            "laplace2d": j_laplace2d(9, 7),
            "elasticity2d": j_elasticity2d(5, 4, e_mod=1.0)}


def port_csr(a):
    return TF.CsrHost(a.row_ptr, a.cols, a.vals, a.shape)


def same_csr(got, want):
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(got.row_ptr, want.row_ptr)
    np.testing.assert_array_equal(got.cols, want.cols)
    np.testing.assert_array_equal(got.vals, want.vals)


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def vec(npad, n, k=None, seed=1):
    v = np.zeros((npad,) if k is None else (npad, k))
    v[:n] = np.random.default_rng(seed).standard_normal(v[:n].shape)
    return v


def python_path(monkeypatch):
    """Take the native library away from both packages' callers."""
    for mod, name in ((tilu, "ilu0_native"), (tilu, "iluk_native"),
                      (tilut, "ilut_native")):
        monkeypatch.setattr(mod, name, lambda *a: None)
    for name in ("ilu0_native", "iluk_native", "ilut_native"):
        monkeypatch.setattr(jnative, name, lambda *a: None)


@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_ilu0_factor_matches_jax(name, native, monkeypatch):
    a = MATRICES[name]
    if not native:
        python_path(monkeypatch)
    want = jilu.ilu0_factor(jilu.iluk_augment(a, 1))
    counts = (tilu.ilu0_factor.native_calls, tilu.ilu0_factor.python_calls)
    got = tilu.ilu0_factor(tilu.iluk_augment(port_csr(a), 1))
    moved = (tilu.ilu0_factor.native_calls - counts[0],
             tilu.ilu0_factor.python_calls - counts[1])
    assert moved == ((1, 0) if native else (0, 1))
    for g, w in zip(got, want):
        same_csr(g, w)


@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_iluk_pattern_native_python_and_jax(k, monkeypatch):
    a = MATRICES["recirc2d"]
    ptr_n, cols_n = tilu.iluk_pattern(port_csr(a), k)
    ptr_j, cols_j = jilu.iluk_pattern(a, k)
    np.testing.assert_array_equal(ptr_n, ptr_j)
    np.testing.assert_array_equal(cols_n, cols_j)
    before = tilu.iluk_pattern.python_calls
    python_path(monkeypatch)
    ptr_p, cols_p = tilu.iluk_pattern(port_csr(a), k)
    assert tilu.iluk_pattern.python_calls == before + 1
    np.testing.assert_array_equal(ptr_p, ptr_n)
    np.testing.assert_array_equal(cols_p, cols_n)
    ptr_jp, cols_jp = jilu.iluk_pattern(a, k)
    np.testing.assert_array_equal(ptr_p, ptr_jp)
    np.testing.assert_array_equal(cols_p, cols_jp)
    if k == 0:
        np.testing.assert_array_equal(ptr_n, a.row_ptr)


@pytest.mark.parametrize("b,k", [(2, 0), (2, 1)])
def test_rbiluk_augment_matches_jax(b, k):
    a = MATRICES["elasticity2d"]
    same_csr(tilu.rbiluk_augment(port_csr(a), b, k),
             jilu.rbiluk_augment(a, b, k))
    with pytest.raises(ValueError, match="not a multiple"):
        tilu.rbiluk_augment(port_csr(j_laplace2d(5, 5)), 2, 0)


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("fill,droptol", [(1.5, 1e-4), (3.0, 1e-3)])
def test_ilut_factor_matches_jax(native, fill, droptol, monkeypatch):
    a = MATRICES["recirc2d"]
    if not native:
        python_path(monkeypatch)
    got = tilut.ilut_factor(port_csr(a), fill, droptol)
    want = jilut.ilut_factor(a, fill, droptol)
    for g, w in zip(got, want):
        same_csr(g, w)


def test_factors_exact_where_nothing_is_dropped():
    """Tridiagonal (laplace1d) and complete-fill ILU(k): L·U == A."""
    a = port_csr(j_laplace1d(20))
    lm, um = tilu.ilu0_factor(a)
    np.testing.assert_allclose(lm.to_dense() @ um.to_dense(), a.to_dense(),
                               atol=1e-12)
    a = port_csr(j_laplace2d(6, 6))
    lm, um = tilu.ilu0_factor(tilu.iluk_augment(a, a.shape[0]))
    np.testing.assert_allclose(lm.to_dense() @ um.to_dense(), a.to_dense(),
                               atol=1e-10)


ILU_CASES = [
    ("RILUK", "recirc2d", {"fact: sweeps": 6}),
    ("ILU", "recirc2d", {"fact: sweeps": 20}),
    ("RILUK", "recirc2d", {"fact: sweeps": 4,
                           "fact: iluk level-of-fill": 2}),
    ("RBILUK", "elasticity2d", {"fact: sweeps": 5, "fact: block size": 2}),
    ("ILUT", "recirc2d", {"fact: sweeps": 6}),
    ("ILUT", "laplace2d", {"fact: sweeps": 3,
                           "fact: ilut level-of-fill": 2.0,
                           "fact: drop tolerance": 1e-3}),
]


@pytest.mark.parametrize("name,mat,params", ILU_CASES)
def test_apply_matches_jax(name, mat, params):
    a = MATRICES[mat]
    jm = jprec.create(name, a, dict(params)).compute()
    tm = tprec.create(name, port_csr(a), dict(params), device="cpu").compute()
    assert type(tm).__name__ == type(jm).__name__
    assert tm.sweeps == jm.sweeps
    np.testing.assert_array_equal(tm._udinv.numpy(), np.asarray(jm._udinv))
    if mat != "elasticity2d":
        assert isinstance(tm._l, TF.DiaMatrix) and isinstance(tm._u,
                                                             TF.DiaMatrix)
    npad = tm._udinv.shape[0]
    st = jax.tree_util.tree_map(np.asarray, (jm._l, jm._u, jm._udinv))
    cm = ilu_from_numpy(port_csr(a), *st, jm.sweeps, dict(params),
                        ilut=name == "ILUT", device="cpu")
    for k in (None, 3):
        r = vec(npad, a.shape[0], k)
        want = np.asarray(jm.apply(jnp.asarray(r)))
        assert rel(tm(torch.from_numpy(r)).numpy(), want) <= TOL
        assert rel(cm(torch.from_numpy(r)).numpy(), want) <= TOL


def test_many_sweeps_approach_the_exact_solve():
    """With 40 sweeps the Jacobi triangular solves reach the exact
    (scipy) forward and backward substitution with the ILU(0) factors."""
    a = port_csr(j_laplace2d(8, 8))
    m = tprec.Ilu0(a, {"fact: sweeps": 40}, device="cpu").compute()
    lm, um = tilu.ilu0_factor(a)
    r = np.random.default_rng(1).standard_normal(64)
    got = m(torch.from_numpy(r)).numpy()
    y = spla.spsolve_triangular(sp.csr_matrix(lm.to_dense()), r, lower=True)
    want = spla.spsolve_triangular(sp.csr_matrix(um.to_dense()), y,
                                   lower=False)
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)


def test_wrong_matrix_type_raises():
    with pytest.raises(TypeError, match="CsrHost"):
        tprec.Ilu0(np.eye(3), device="cpu").compute()
    with pytest.raises(TypeError, match="CsrHost"):
        tprec.Ilut(np.eye(3), device="cpu").compute()
