"""Port parity: the matrix-free stencil SpMV against the JAX package.

The same seeded numpy inputs go through ``trilinos_tpu`` (the Pallas
kernels in interpret mode where their plans apply, else the XLA
reference ``stencil_spmv_xla``) and through ``trilinos_tpu_torch`` on the
CPU, where the kernel wrapper runs its plain PyTorch version.
Tolerances are max|Δ| / max|y|: 1e-6 in f32 (the Pallas kernels add the
terms in another order), 1e-13 in f64; 1e-5 for the multivector kernel
in f32, the tolerance of the JAX package's own test of it.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trilinos_tpu.galeri import stencils as jst
from trilinos_tpu.ops import matvec as jmv
from trilinos_tpu.ops.pallas import stencil_op as jso

from trilinos_tpu_torch.galeri import stencils as tst
from trilinos_tpu_torch.ops import StencilOp, spmv, stencil_spmm, stencil_spmv
from trilinos_tpu_torch.ops.stencil_op import stencil_spmv_plain

LAP3 = [((0, 0, 0), 6.0), ((-1, 0, 0), -1.0), ((1, 0, 0), -1.0),
        ((0, -1, 0), -1.0), ((0, 1, 0), -1.0), ((0, 0, -1), -1.0),
        ((0, 0, 1), -1.0)]
LAP2 = [((0, 0), 4.0), ((-1, 0), -1.0), ((1, 0), -1.0), ((0, -1), -1.0),
        ((0, 1), -1.0)]
# Galeri Star2D with unequal corner weights: diagonal offsets, nonsymmetric
STAR2 = tst.star2d_stencil(8.0, -1.0, -1.5, -0.5, -2.0, -0.25, -0.3,
                           -0.35, -0.4)


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def both(dims, st, n_rows_pad=None, dtype="float32"):
    return (jso.StencilOp.create(dims, st, n_rows_pad=n_rows_pad,
                                 dtype=dtype),
            StencilOp.create(dims, st, n_rows_pad=n_rows_pad, dtype=dtype))


def rand_x(op, dtype, seed, fill_pad=False):
    x = np.zeros(op.n_rows_pad, dtype)
    n = op.n_rows_pad if fill_pad else op.n_rows
    x[:n] = np.random.default_rng(seed).standard_normal(n)
    return x


@pytest.mark.parametrize("dims,st,pallas", [
    ((32, 32, 8), LAP3, "planes"),    # nx·ny % 1024 == 0: plane kernel
    ((16, 16, 16), LAP3, "masked"),   # the entry grid: masked kernel
    ((16, 16, 8), LAP3, None),        # no Pallas plan: XLA reference only
    ((12, 10, 6), LAP3, None),
    ((32, 32), LAP2, None),
])
def test_f32_matches_jax(dims, st, pallas):
    jop, top = both(dims, st)
    x = rand_x(top, np.float32, seed=1)
    y = stencil_spmv(top, torch.from_numpy(x)).numpy()
    assert y.dtype == np.float32
    want = {"planes": jso.stencil_spmv_planes,
            "masked": jso.stencil_spmv_masked}.get(pallas)
    if want is not None:
        assert rel(y, want(jop, jnp.asarray(x), interpret=True)) <= 1e-6
    assert rel(y, jso.stencil_spmv_xla(jop, jnp.asarray(x))) <= 1e-6


def test_padded_rows_are_identity():
    jop, top = both((16, 16, 16), LAP3, n_rows_pad=4096 + 1024)
    x = rand_x(top, np.float32, seed=2, fill_pad=True)
    y = stencil_spmv(top, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(y[top.n_rows:], x[top.n_rows:])
    assert rel(y, jso.stencil_spmv_masked(jop, jnp.asarray(x),
                                          interpret=True)) <= 1e-6


def test_star2d_diagonal_offsets_and_transpose():
    jop, top = both((24, 20), STAR2, dtype="float64")
    x = rand_x(top, np.float64, seed=3)
    xt = torch.from_numpy(x)
    assert rel(spmv(top, xt).numpy(),
               jmv.spmv(jop, jnp.asarray(x))) <= 1e-13
    yt = spmv(top, xt, transpose=True).numpy()
    assert rel(yt, jmv.spmv(jop, jnp.asarray(x), transpose=True)) <= 1e-13
    # the transpose is Aᵀ of the assembled matrix
    a = tst.stencil_csr((24, 20), STAR2).to_dense()
    assert rel(yt[:top.n_rows], a.T @ x[:top.n_rows]) <= 1e-13
    assert rel(yt, spmv(top, xt).numpy()) > 1e-3  # nonsymmetric stencil


@pytest.mark.parametrize("dims,st", [((16, 16, 16), LAP3),
                                     ((12, 10, 6), LAP3),
                                     ((32, 32), LAP2)])
def test_f64_matches_jax(dims, st):
    jop, top = both(dims, st, dtype="float64")
    x = rand_x(top, np.float64, seed=4)
    y = stencil_spmv(top, torch.from_numpy(x)).numpy()
    assert y.dtype == np.float64
    assert rel(y, jso.stencil_spmv_xla(jop, jnp.asarray(x))) <= 1e-13
    # and against the assembled matrix of both packages' Galeri copies
    a = jst.stencil_csr(dims, st).to_dense()
    assert rel(y[:top.n_rows], a @ x[:top.n_rows]) <= 1e-13


def test_multivector_columns():
    _, top = both((16, 16, 8), LAP3, dtype="float64")
    rng = np.random.default_rng(5)
    xk = np.zeros((top.n_rows_pad, 3))
    xk[:top.n_rows] = rng.standard_normal((top.n_rows, 3))
    yk = spmv(top, torch.from_numpy(xk)).numpy()
    for j in range(3):
        np.testing.assert_array_equal(
            yk[:, j], spmv(top, torch.from_numpy(xk[:, j].copy())).numpy())


def rand_xk(op, k, dtype, seed, fill_pad=False):
    x = np.zeros((op.n_rows_pad, k), dtype)
    n = op.n_rows_pad if fill_pad else op.n_rows
    x[:n] = np.random.default_rng(seed).standard_normal((n, k))
    return x


@pytest.mark.parametrize("k", [1, 2, 4, 16])
def test_multivector_f32_matches_jax_kernel(k):
    """The TPU multivector kernel (``stencil_spmm_packed`` behind
    ``stencil_spmm_pallas``) in interpret mode, on the geometry of the JAX
    package's own test."""
    jop, top = both((32, 32, 8), LAP3)
    assert jso.stencil_spmm_applicable(jop, k)
    x = rand_xk(top, k, np.float32, seed=6)
    y = stencil_spmv(top, torch.from_numpy(x)).numpy()
    assert y.shape == (top.n_rows_pad, k) and y.dtype == np.float32
    want = jso.stencil_spmm_pallas(jop, jnp.asarray(x), interpret=True)
    assert rel(y, want) <= 1e-5
    # a 2-D x through stencil_spmv is stencil_spmm
    np.testing.assert_array_equal(
        stencil_spmm(top, torch.from_numpy(x)).numpy(), y)


@pytest.mark.parametrize("k", [1, 3, 16])
def test_multivector_padded_rows_are_identity(k):
    """A grid whose rows do not fill the padding (10×10×8: 800 rows in
    1024), the small geometry the card check uses too."""
    jop, top = both((10, 10, 8), LAP3, dtype="float64")
    x = rand_xk(top, k, np.float64, seed=7, fill_pad=True)
    y = stencil_spmm(top, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(y[top.n_rows:], x[top.n_rows:])
    assert rel(y, jso.stencil_spmv_xla(jop, jnp.asarray(x))) <= 1e-13


def test_galeri_emit_matches_jax():
    jop = jst.laplace3d(12, 10, 6, fmt="stencil")
    top = tst.laplace3d(12, 10, 6, fmt="stencil")
    for field in ("dims", "offsets", "coeffs", "n_rows_pad", "dtype"):
        assert getattr(top, field) == getattr(jop, field)
    assert top.nnz == jop.nnz
    with pytest.raises(ValueError):
        tst.laplace3d(4, 4, 4, fmt="stencil", device="cpu")


def test_wrapper_refuses_other_devices():
    _, top = both((8, 8, 8), LAP3)
    x = torch.zeros(top.n_rows_pad, device="meta")
    with pytest.raises(ValueError, match="not supported"):
        stencil_spmv(top, x)
    with pytest.raises(ValueError, match="x length"):
        stencil_spmv_plain(top, torch.zeros(top.n_rows_pad + 8))


def test_multivector_wrapper_refuses_other_devices():
    _, top = both((8, 8, 8), LAP3)
    x = torch.zeros((top.n_rows_pad, 4), device="meta")
    for fn in (stencil_spmv, stencil_spmm):
        with pytest.raises(ValueError, match="not supported"):
            fn(top, x)
    with pytest.raises(ValueError, match="x length"):
        stencil_spmm(top, torch.zeros((top.n_rows_pad + 8, 4)))
