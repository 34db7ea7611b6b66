"""Port parity: certified conjugate gradients against the JAX package.

BASELINE config 1 (Galeri Laplace2D 100×100 as stored DIA, unpreconditioned
CG to rtol 1e-8, f64) runs through both packages from the same seeded
right-hand side: the iteration counts must be equal and the solutions agree
to 1e-10 (max|Δ| / max|x|). The remaining cases pin the retry loop's edges.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trilinos_tpu.galeri import laplace2d as j_laplace2d
from trilinos_tpu.ops import formats as jF
from trilinos_tpu.ops import matvec as jmv
from trilinos_tpu.solvers import cg as j_cg

from trilinos_tpu_torch.galeri import laplace2d
from trilinos_tpu_torch.ops import csr_to_dia, spmv
from trilinos_tpu_torch.solvers import cg


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def rhs(npad, n, seed, dtype=np.float64, k=None):
    tail = () if k is None else (k,)
    b = np.zeros((npad,) + tail, dtype)
    b[:n] = np.random.default_rng(seed).standard_normal((n,) + tail)
    return b


def test_baseline_config1_matches_jax():
    a = j_laplace2d(100, 100)
    jdev = jF.csr_to_dia(a)
    tdev = csr_to_dia(laplace2d(100, 100), device="cpu")
    assert tdev.offsets == jdev.offsets
    n = 10000
    b = rhs(jdev.n_rows_pad, n, seed=0)
    jres = j_cg(lambda x: jmv.spmv(jdev, x, impl="xla"), jnp.asarray(b),
                rtol=1e-8)
    tres = cg(lambda x: spmv(tdev, x), torch.from_numpy(b), rtol=1e-8)
    assert bool(tres.converged) and bool(jres.converged)
    assert tres.iters == int(jres.iters)
    assert rel(tres.x.numpy(), jres.x) <= 1e-10
    assert float(tres.resnorm) == pytest.approx(float(jres.resnorm),
                                                rel=1e-6)
    # the certified residual is the true one
    x = tres.x.numpy()[:n]
    true = np.linalg.norm(b[:n] - a.matvec_host(x)) / np.linalg.norm(b[:n])
    assert true <= 1e-8


def test_maxiter_zero():
    dev = csr_to_dia(laplace2d(16, 16), device="cpu")
    b = torch.from_numpy(rhs(dev.n_rows_pad, 256, seed=1))
    res = cg(lambda x: spmv(dev, x), b, maxiter=0)
    assert res.iters == 0
    assert not bool(res.converged)
    np.testing.assert_array_equal(res.x.numpy(), 0.0)


def test_unattainable_f32_tolerance_stops():
    """rtol 1e-12 is below f32's reach: the 4-pass retry cap ends the
    solve long before maxiter and reports converged=False."""
    dev = csr_to_dia(laplace2d(32, 32, dtype=np.float32), device="cpu")
    b = torch.from_numpy(rhs(dev.n_rows_pad, 1024, seed=2, dtype=np.float32))
    res = cg(lambda x: spmv(dev, x), b, rtol=1e-12, maxiter=100000)
    assert not bool(res.converged)
    assert res.iters < 2000
    assert res.x.dtype == torch.float32


def test_multivector_columns_match_jax():
    jdev = jF.csr_to_dia(j_laplace2d(24, 24))
    tdev = csr_to_dia(laplace2d(24, 24), device="cpu")
    b = rhs(jdev.n_rows_pad, 576, seed=3, k=3)
    b[:, 2] *= 1e-3  # columns converge at different iterations
    jres = j_cg(lambda x: jmv.spmv(jdev, x, impl="xla"), jnp.asarray(b),
                rtol=1e-8)
    tres = cg(lambda x: spmv(tdev, x), torch.from_numpy(b), rtol=1e-8)
    assert tres.iters == int(jres.iters)
    assert bool(tres.converged.all())
    assert rel(tres.x.numpy(), jres.x) <= 1e-10


@pytest.mark.parametrize("opt", [dict(condest_window=5), dict(history=True),
                                 dict(stop=object()),
                                 dict(compensated=True)])
def test_unported_options_raise(opt):
    dev = csr_to_dia(laplace2d(8, 8), device="cpu")
    b = torch.from_numpy(rhs(dev.n_rows_pad, 64, seed=4))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cg(lambda x: spmv(dev, x), b, **opt)
