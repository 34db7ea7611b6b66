"""The port's matrix filters, condition estimates, BLAS leftovers and
``rap`` against the JAX package's.

Every filter (local, diagonal, drop, sparsity with and without a
bandwidth, singleton, reorder through ``parallel.partition.permute_csr``)
gives the reference's CSR bit for bit on Galeri ``recirc2d`` with
Dirichlet-like singleton rows. ``condest`` on a Jacobi apply of
``laplace2d`` 16², f64: "cheap" and "power" (the same seeded start, one
host read a step) to 1e-12 of the reference's, "lanczos" to 1e-9 and
within 5% of the true condition number. ``update``, ``scale`` and
``set_block`` equal the reference's; ``mv_random`` is held to its law
(shape, dtype, zero pad rows, moments of 4,096 draws), not its values,
since ``jax.random``'s stream cannot be matched; ``rap`` equals the
reference's triple product to 1e-13.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trilinos_tpu import precond as jprec
from trilinos_tpu.galeri import laplace2d as j_laplace2d
from trilinos_tpu.galeri import recirc2d as j_recirc2d
from trilinos_tpu.ops import blas as jblas
from trilinos_tpu.ops import choose_format as j_choose_format
from trilinos_tpu.ops import filters as jf
from trilinos_tpu.ops import formats as JF
from trilinos_tpu.ops import spmv as j_spmv
from trilinos_tpu.ops.matrix_ops import rap as j_rap

from trilinos_tpu_torch import precond as tprec
from trilinos_tpu_torch.ops import blas, choose_format, filters, rap, spmv
from trilinos_tpu_torch.ops import formats as TF
from torch_threads import one_thread  # noqa: F401  (autouse)


def port_csr(a):
    return TF.CsrHost(a.row_ptr, a.cols, a.vals, a.shape)


def same_csr(got, want):
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(got.row_ptr, want.row_ptr)
    np.testing.assert_array_equal(got.cols, want.cols)
    np.testing.assert_array_equal(got.vals, want.vals)


def with_singletons():
    a = j_recirc2d(8, 6, diff=1e-2)
    d = a.to_dense()
    d[[0, 17, 47]] = 0
    d[[0, 17, 47], [0, 17, 47]] = 1.0
    return JF.CsrHost.from_dense(d)


A = with_singletons()
PERM = np.random.default_rng(0).permutation(A.shape[0])
FILTERS = {
    "local": lambda m, f: m.local_filter(f, 6, 30),
    "diagonal": lambda m, f: m.diagonal_filter(f, absolute_threshold=0.5,
                                               relative_threshold=1.1),
    "drop": lambda m, f: m.drop_filter(f, 0.9),
    "sparsity": lambda m, f: m.sparsity_filter(f, max_entries_per_row=2),
    "sparsity banded": lambda m, f: m.sparsity_filter(
        f, max_entries_per_row=3, max_bandwidth=1),
    "singleton": lambda m, f: m.singleton_filter(f)[0],
    "reorder": lambda m, f: m.reorder_filter(f, PERM),
}


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_filter_matches_jax(name):
    same_csr(FILTERS[name](filters, port_csr(A)), FILTERS[name](jf, A))


def test_singleton_rows_and_reorder():
    got, kept = filters.singleton_filter(port_csr(A))
    want, jkept = jf.singleton_filter(A)
    np.testing.assert_array_equal(kept, jkept)
    assert got.shape[0] == A.shape[0] - 3
    d = filters.reorder_filter(port_csr(A), PERM).to_dense()
    np.testing.assert_array_equal(d, A.to_dense()[np.ix_(PERM, PERM)])


@pytest.fixture(scope="module")
def jacobi_pair():
    a = j_laplace2d(16, 16)
    jm = jprec.Relaxation(a, {"relaxation: damping factor": 0.8}).compute()
    tm = tprec.Relaxation(port_csr(a), {"relaxation: damping factor": 0.8},
                          device="cpu").compute()
    return a, jm, tm


@pytest.mark.parametrize("method", ["cheap", "power"])
def test_condest_matches_jax(jacobi_pair, method):
    a, jm, tm = jacobi_pair
    want = jf.condest(jm, 256, method=method, iters=12, seed=3)
    got = filters.condest(tm, 256, method=method, iters=12, seed=3,
                          device="cpu")
    assert abs(got - want) <= 1e-12 * abs(want)
    with pytest.raises(ValueError, match="unknown condest"):
        filters.condest(tm, 256, method="exact", device="cpu")


def test_condest_lanczos_matches_jax():
    """λmax/λmin of the SPD operator (pad rows masked, as the reference's
    test does) against the reference's estimate and the true κ."""
    a = j_laplace2d(16, 16)
    n = a.shape[0]
    jdev = j_choose_format(a)
    npad = jdev.n_rows_pad
    tdev = choose_format(port_csr(a), device="cpu")
    mask = torch.arange(npad) < n
    jmask = jnp.arange(npad) < n

    def jop(v):
        return jnp.where(jmask, j_spmv(jdev, jnp.where(jmask, v, 0.0)), 0.0)

    def op(v):
        return torch.where(mask, spmv(tdev, torch.where(mask, v, 0.0)), 0.0)

    want = jf.condest(jop, npad, method="lanczos", iters=30)
    got = filters.condest(op, npad, method="lanczos", iters=30,
                          device="cpu")
    assert abs(got - want) <= 1e-9 * want
    kappa = float(np.linalg.cond(a.to_dense()))
    assert abs(got - kappa) / kappa < 0.05


def test_update_scale_set_block_match_jax():
    rng = np.random.default_rng(4)
    x, y, z = (rng.standard_normal((24, 5)) for _ in range(3))
    t = [torch.from_numpy(v) for v in (x, y, z)]
    j = [jnp.asarray(v) for v in (x, y, z)]
    np.testing.assert_array_equal(
        blas.update(0.5, t[0], -2.0, t[1], 3.0, t[2]).numpy(),
        np.asarray(jblas.update(0.5, j[0], -2.0, j[1], 3.0, j[2])))
    np.testing.assert_array_equal(blas.scale(-1.5, t[0]).numpy(),
                                  np.asarray(jblas.scale(-1.5, j[0])))
    src = rng.standard_normal((24, 2))
    got = blas.set_block(torch.from_numpy(src), t[1], (1, 4))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jblas.set_block(jnp.asarray(src), j[1],
                                                (1, 4))))
    np.testing.assert_array_equal(t[1].numpy(), y)  # dst is not changed


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mv_random_law(dtype):
    g = torch.Generator().manual_seed(11)
    x = blas.mv_random(4096, 3, dtype, n_valid=4000, generator=g,
                       device="cpu")
    assert x.shape == (4096, 3) and x.dtype == dtype
    assert bool((x[4000:] == 0).all())
    body = x[:4000].double()
    assert float(body.mean().abs()) < 0.05
    assert abs(float(body.std()) - 1.0) < 0.05
    assert bool((body != 0).all())
    g2 = torch.Generator().manual_seed(11)
    torch.testing.assert_close(blas.mv_random(4096, 3, dtype, 4000, g2,
                                              device="cpu"), x)


def test_rap_matches_jax():
    a = j_recirc2d(8, 8, diff=1e-2)
    rng = np.random.default_rng(5)
    p = JF.CsrHost.from_dense(rng.standard_normal((64, 9))
                              * (rng.random((64, 9)) < 0.3))
    r = p.transpose()
    got = rap(port_csr(r), port_csr(a), port_csr(p))
    want = j_rap(r, a, p)
    assert tuple(got.shape) == tuple(want.shape) == (9, 9)
    np.testing.assert_allclose(got.to_dense(), want.to_dense(), rtol=0,
                               atol=1e-13 * np.abs(want.vals).max())
