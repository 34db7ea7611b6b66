"""Port parity: block-DIA storage and applies against the JAX package.

The same host CSR goes to both packages' ``csr_to_bdia``; the same seeded
numpy x goes through the JAX XLA applies (``bdia_spmm``, ``bdia_spmm_t``),
its TPU kernel in interpret mode and its plane-layout solver op, and
through the port's wrappers, which run the plain PyTorch versions on the
CPU. Tolerances are max|Δ| / max|y|: 1e-12 in f64 (for b > 4 the JAX
package sums with one einsum per offset, in another order); 1e-6 where
bf16 data are summed in f32. The interpret-mode kernel sums in f32, so it
gets data and x whose products and sums f32 holds exactly, and then must
agree to 1e-12 as well.
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trilinos_tpu.galeri import elasticity2d as j_elasticity2d
from trilinos_tpu.ops import formats as jF
from trilinos_tpu.ops import matvec as jmv
from trilinos_tpu.ops.pallas import bdia_spmv as jB

from trilinos_tpu_torch.convert import bdia_from_numpy
from trilinos_tpu_torch.ops import (CsrHost, bdia_plane_solver_op, bdia_spmm,
                                    bdia_spmv, csr_to_bdia, pack_planes,
                                    spmv, unpack_planes)
from torch_threads import one_thread  # noqa: F401  (autouse)

tB = importlib.import_module("trilinos_tpu_torch.ops.bdia_spmv")


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def block_stencil(rng, nb, b, offsets, dtype=np.float64):
    """(row, col, val) of a random block stencil: dense (b, b) blocks at
    constant block offsets, in range only (``tests/test_formats.py``)."""
    rows, cols, vals = [], [], []
    for o in offsets:
        qs = np.arange(max(0, -o), min(nb, nb - o))
        blocks = rng.standard_normal((len(qs), b, b)).astype(dtype)
        for bi in range(b):
            for bj in range(b):
                rows.append(qs * b + bi)
                cols.append((qs + o) * b + bj)
                vals.append(blocks[:, bi, bj])
    return (np.concatenate(rows), np.concatenate(cols), np.concatenate(vals),
            (nb * b, nb * b))


def both(rows, cols, vals, shape):
    """The same COO as a JAX and a port CsrHost."""
    return (jF.CsrHost.from_coo(rows, cols, vals, shape),
            CsrHost.from_coo(rows, cols, vals, shape))


def same_storage(j, t):
    assert t.offsets == j.offsets and t.block_size == j.block_size
    assert (t.n_rows, t.n_cols, t.nnz, t.nbr_pad, t.n_rows_pad) == (
        j.n_rows, j.n_cols, j.nnz, j.nbr_pad, j.n_rows_pad)
    np.testing.assert_array_equal(t.data.double().numpy(),
                                  np.asarray(j.data_flat, np.float64))


def rand_x(a, nrhs, seed, dtype=np.float64):
    x = np.zeros((a.n_rows_pad, nrhs) if nrhs else a.n_rows_pad, dtype)
    x[:a.n_rows] = np.random.default_rng(seed).standard_normal(
        x[:a.n_rows].shape)
    return x


def test_csr_to_bdia_matches_jax(rng):
    """Storage, identity pad blocks, dense form: mirrors
    tests/test_formats.py TestBdia."""
    j, t = both(*block_stencil(rng, 13, 2, (-3, -1, 0, 1, 3)))
    jd, td = jF.csr_to_bdia(j, 2), csr_to_bdia(t, 2, device="cpu")
    same_storage(jd, td)
    assert td.offsets == (-3, -1, 0, 1, 3) and td.nbr_pad == 16
    np.testing.assert_array_equal(td.to_dense(), jF.to_dense(jd))
    np.testing.assert_allclose(td.to_dense(), t.to_dense(), rtol=0, atol=0)
    d0 = td.offsets.index(0)
    for i in range(2):
        np.testing.assert_array_equal(td.data[d0, i, i, 13:].numpy(), 1.0)
        assert float(td.data[d0, i, 1 - i, 13:].abs().max()) == 0.0
    # a missing zero offset gets an identity-padded plane
    j, t = both(*block_stencil(rng, 6, 2, (-1, 1)))
    jd, td = jF.csr_to_bdia(j, 2), csr_to_bdia(t, 2, device="cpu")
    same_storage(jd, td)
    assert 0 in td.offsets
    # dims that are no multiple of b are identity-extended
    m = 11
    rows, cols = rng.integers(0, m, 70), rng.integers(0, m, 70)
    j, t = both(rows, cols, rng.standard_normal(70), (m, m))
    jd, td = jF.csr_to_bdia(j, 2), csr_to_bdia(t, 2, device="cpu")
    same_storage(jd, td)
    assert td.n_rows == 12
    np.testing.assert_array_equal(td.to_dense()[:m, :m], t.to_dense())
    assert td.to_dense()[m, m] == 1.0
    with pytest.raises(ValueError, match="block offsets exceeds"):
        csr_to_bdia(t, 2, max_diags=2, device="cpu")


@pytest.mark.parametrize("b", [2, 3, 4, 6])
@pytest.mark.parametrize("nrhs", [0, 3])
def test_applies_match_jax_f64(rng, b, nrhs):
    offsets = (-7, -3, -1, 0, 1, 2, 5)
    j, t = both(*block_stencil(rng, 21, b, offsets))
    jd, td = jF.csr_to_bdia(j, b), csr_to_bdia(t, b, device="cpu")
    same_storage(jd, td)
    x = rand_x(td, nrhs, seed=b)
    xt = torch.from_numpy(x)
    assert rel(bdia_spmv(td, xt).numpy(), jmv.bdia_spmm(jd, jnp.asarray(x))) \
        <= 1e-12
    assert rel(spmv(td, xt, transpose=True).numpy(),
               jmv.bdia_spmm_t(jd, jnp.asarray(x))) <= 1e-12
    dense = t.to_dense()
    np.testing.assert_allclose(bdia_spmv(td, xt).numpy()[:td.n_rows],
                               dense @ x[:td.n_rows], rtol=1e-12, atol=1e-12)


def _exact_elasticity2d(nx=64, ny=48):
    """elasticity2d's pattern with values on a 1/64 grid and integer x:
    every product and partial sum is exact in f32."""
    a = j_elasticity2d(nx, ny, e_mod=1.0)
    vals = np.round(a.vals * 64.0) / 64.0
    j = jF.CsrHost(a.row_ptr, a.cols, vals, a.shape)
    t = CsrHost(a.row_ptr, a.cols, vals, a.shape)
    return j, t


@pytest.mark.parametrize("k", [1, 4])
def test_plain_matches_interpret_mode_tpu_kernel(k):
    j, t = _exact_elasticity2d()
    jd = jF.csr_to_bdia(j, 2, dtype=np.float32)
    td = csr_to_bdia(t, 2, device="cpu")
    assert jB.bdia_pallas_applicable(jd, k) and td.nbr_pad % 128 == 0
    x = np.zeros((td.n_rows_pad, k))
    x[:td.n_rows] = np.random.default_rng(k).integers(-4, 5,
                                                       (td.n_rows, k))
    y = bdia_spmm(td, torch.from_numpy(x)).numpy()
    yk = jB.bdia_spmm_pallas(jd, jnp.asarray(x, jnp.float32), interpret=True)
    assert rel(y, yk) <= 1e-12
    # the packed-plane form the kernel itself takes
    xp = pack_planes(td, torch.from_numpy(x))
    yp = jB.bdia_spmm_packed(jd, jnp.asarray(xp.numpy(), jnp.float32)
                             .reshape(2 * k, -1, 128), interpret=True)
    assert rel(bdia_spmm(td, xp, layout="planes").numpy(),
               np.asarray(yp).reshape(2 * k, -1)) <= 1e-12


@pytest.mark.parametrize("k", [1, 2])
def test_plane_solver_op_matches_jax(rng, k):
    j, t = both(*block_stencil(rng, 40, 3, (-9, -1, 0, 1, 9)))
    jd, td = jF.csr_to_bdia(j, 3), csr_to_bdia(t, 3, device="cpu")
    jop, jpack, junpack = jB.bdia_plane_solver_op(jd, k)
    op, pack, unpack = bdia_plane_solver_op(td, k)
    x = rand_x(td, k if k > 1 else 0, seed=7)
    v = pack(torch.from_numpy(x))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jpack(jnp.asarray(x))))
    w = op(v)
    assert w.shape == v.shape
    assert rel(w.numpy(), jop(jnp.asarray(v.numpy()))) <= 1e-12
    np.testing.assert_array_equal(unpack(w).numpy(),
                                  np.asarray(junpack(jnp.asarray(w.numpy()))))
    np.testing.assert_array_equal(unpack(v).numpy(), x)
    # planes hold the same apply as the interleaved layout
    y = bdia_spmv(td, torch.from_numpy(x)).numpy()
    assert rel(unpack(w).numpy(), y) <= 1e-15
    assert rel(unpack_planes(td, pack_planes(td, torch.from_numpy(x)))
               .numpy().reshape(x.shape), x) == 0.0


def test_bf16_data_f32_x_matches_jax():
    a = j_elasticity2d(24, 16, e_mod=1.0)
    vals = a.vals * np.random.default_rng(3).uniform(0.9, 1.1, a.nnz)
    jd = jF.csr_to_bdia(jF.CsrHost(a.row_ptr, a.cols, vals, a.shape), 2,
                        dtype=jnp.bfloat16)
    # the port's packing rounds the same f64 values to the same bf16, and
    # the JAX package's data carried across widen exactly
    tp = csr_to_bdia(CsrHost(a.row_ptr, a.cols, vals, a.shape), 2,
                     dtype=torch.bfloat16, device="cpu")
    td = bdia_from_numpy(jd.data, jd.offsets, 2, jd.n_rows, jd.n_cols,
                         jd.nnz, device="cpu")
    assert tp.dtype == td.dtype == torch.bfloat16
    for m in (tp, td):
        np.testing.assert_array_equal(m.data.float().numpy(),
                                      np.asarray(jd.data_flat, np.float32))
    x = rand_x(td, 0, seed=4, dtype=np.float32)
    y = bdia_spmv(td, torch.from_numpy(x))
    assert y.dtype == torch.float32
    assert rel(y.numpy(), jmv.bdia_spmm(jd, jnp.asarray(x))) <= 1e-6


def test_shape_checks_and_cpu_counters(rng):
    j, t = both(*block_stencil(rng, 10, 3, (-2, 0, 2)))
    td = csr_to_bdia(t, 3, device="cpu")
    bdia_spmv.launches = bdia_spmm.launches = 0
    with pytest.raises(ValueError, match="BDIA spmv: x of shape"):
        bdia_spmv(td, torch.zeros(td.n_rows_pad - 1, dtype=torch.float64))
    with pytest.raises(ValueError, match="BDIA spmv: x of shape"):
        spmv(td, torch.zeros((td.n_rows_pad + 3, 2), dtype=torch.float64))
    with pytest.raises(ValueError, match="BDIA planes"):
        bdia_spmm(td, torch.zeros((4, td.nbr_pad), dtype=torch.float64),
                  layout="planes")
    op, pack, _ = bdia_plane_solver_op(td, 2)
    with pytest.raises(ValueError, match="columns"):
        pack(torch.zeros(td.n_rows_pad, dtype=torch.float64))
    with pytest.raises(ValueError, match="BDIA planes"):
        op(torch.zeros(3 * td.nbr_pad, dtype=torch.float64))
    with pytest.raises(ValueError, match="layout"):
        bdia_spmm(td, torch.zeros((td.n_rows_pad, 1)), layout="rows")
    x = torch.from_numpy(rand_x(td, 2, seed=1))
    bdia_spmm(td, x)
    bdia_spmv(td, x[:, 0].contiguous())
    assert bdia_spmv.launches == 0 and bdia_spmm.launches == 0
    with pytest.raises(ValueError, match="not supported"):
        bdia_spmv(td, x[:, 0].to("meta"))
    # what the kernel wrapper hands the kernel: the (q, j, m) strides of
    # both layouts
    assert tB._interleaved(td, x).stride() == (6, 2, 1)
    assert tB._planes(td, pack_planes(td, x)).stride() == (
        1, 2 * td.nbr_pad, td.nbr_pad)
