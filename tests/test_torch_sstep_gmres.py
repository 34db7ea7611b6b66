"""Port parity: s-step GMRES, its basis set-up and the Arnoldi process.

The same seeded right-hand sides go through both packages in f64. The
port's loop basis and its fused basis (``stencil_powers_apply``, whose
CPU path is the plain version) must take the JAX loop basis's ``iters``
and reach its x to 1e-9 (max|Δ| / max|x|): with a monomial basis on a grid
with pad rows, with the bench configuration of ``sstep_entry`` at 16³, and
with Newton shifts from ``ritz_shifts`` on an operator whose Ritz values
hold a conjugate pair. A bf16 basis is held to the same bounds: both
packages round the basis to bf16 at the same points and widen it to f64
before each product, so nothing but summation order separates them.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trilinos_tpu.eigen.lanczos import arnoldi as j_arnoldi
from trilinos_tpu.eigen.lanczos import lanczos_eigs as j_lanczos_eigs
from trilinos_tpu.galeri import laplace3d as j_laplace3d
from trilinos_tpu.ops import spmv as j_spmv
from trilinos_tpu.ops.pallas.stencil_op import StencilOp as JStencilOp
from trilinos_tpu.solvers.sstep_gmres import (
    estimate_opnorm as j_estimate_opnorm, leja_order as j_leja_order,
    newton_basis_stages as j_newton_basis_stages,
    ritz_shifts as j_ritz_shifts, sstep_gmres as jss)

from trilinos_tpu_torch.eigen import arnoldi, lanczos_eigs
from trilinos_tpu_torch.entry import sstep_entry
from trilinos_tpu_torch.galeri import laplace3d
from trilinos_tpu_torch.ops import StencilOp, spmv, stencil_powers_apply
from trilinos_tpu_torch.solvers.sstep_gmres import (
    estimate_opnorm, leja_order, newton_basis_stages, ritz_shifts,
    sstep_gmres as tss)
from torch_threads import one_thread  # noqa: F401  (autouse)

# (1, 0) and (-1, 0) of opposite signs: the x factor has complex eigenvalues
NONSYM = [((0, 0), 4.0), ((1, 0), -1.0), ((-1, 0), 0.6), ((0, 1), -1.0),
          ((0, -1), -1.0)]


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def problem(dims, seed, stencil=None):
    """(JAX op, port op, b) in f64; b is zero in the pad rows."""
    if stencil is None:
        jop = j_laplace3d(*dims, dtype=np.float64, fmt="stencil")
        top = laplace3d(*dims, dtype=np.float64, fmt="stencil")
    else:
        jop = JStencilOp.create(dims, stencil, dtype="float64")
        top = StencilOp.create(dims, stencil, dtype="float64")
    b = np.zeros(jop.n_rows_pad)
    b[:jop.n_rows] = np.random.default_rng(seed).standard_normal(jop.n_rows)
    return jop, top, b


KW = dict(s=4, t_blocks=4, max_restarts=20, rtol=1e-8)


@functools.lru_cache(maxsize=None)
def jax_monomial(basis_dtype=None):
    jop, _, b = problem((12, 10, 6), 5)  # 720 rows in 1024: pad rows
    return jss(jop, jnp.asarray(b), basis_impl="loop",
               basis_dtype=basis_dtype, **KW)


@pytest.mark.parametrize("impl", ["loop", "fused", "auto"])
def test_monomial_basis_matches_jax_loop(impl):
    _, top, b = problem((12, 10, 6), 5)
    jres = jax_monomial()
    stencil_powers_apply.launches = 0
    res = tss(top, torch.from_numpy(b), basis_impl=impl, **KW)
    assert bool(res.converged) and bool(jres.converged)
    assert res.iters == int(jres.iters)
    assert rel(res.x.numpy(), jres.x) <= 1e-9
    assert float(res.resnorm) == pytest.approx(float(jres.resnorm), rel=1e-6)
    assert stencil_powers_apply.launches == 0


def test_bf16_basis_matches_jax():
    _, top, b = problem((12, 10, 6), 5)
    jres = jax_monomial(jnp.bfloat16)
    res = tss(top, torch.from_numpy(b), basis_impl="loop",
              basis_dtype=torch.bfloat16, **KW)
    assert bool(res.converged) == bool(jres.converged)
    assert res.iters == int(jres.iters)
    assert rel(res.x.numpy(), jres.x) <= 1e-9


def test_sstep_entry_twin_matches_jax():
    """The bench configuration: σ = 12, rtol 0, five cycles of 32."""
    step, (b,) = sstep_entry(dtype=np.float64, device="cpu")
    res = step(b)
    jop, _, jb = problem((16, 16, 16), 0)
    np.testing.assert_array_equal(b.numpy(), jb)
    jres = jss(jop, jnp.asarray(jb), s=4, t_blocks=8, max_restarts=4,
               rtol=0.0, sigma=12.0)
    assert res.iters == int(jres.iters) == 160
    assert rel(res.x.numpy(), jres.x) <= 1e-9


def test_newton_shifts_match_jax():
    jop, top, b = problem((16, 16), 7, NONSYM)
    jsh = j_ritz_shifts(jop, jnp.asarray(b), 4)
    sh = ritz_shifts(top, torch.from_numpy(b), 4)
    assert np.abs(sh.imag).max() > 1e-3  # a conjugate pair
    np.testing.assert_allclose(sh, jsh, rtol=1e-10)
    kw = dict(s=4, t_blocks=4, max_restarts=30, rtol=1e-8)
    jres = jss(jop, jnp.asarray(b), basis_impl="loop", shifts=jsh, **kw)
    for impl in ("loop", "fused"):
        res = tss(top, torch.from_numpy(b), basis_impl=impl, shifts=sh,
                  **kw)
        assert bool(res.converged) and bool(jres.converged)
        assert res.iters == int(jres.iters)
        assert rel(res.x.numpy(), jres.x) <= 1e-9


def test_basis_setup_matches_jax():
    vals = np.array([1.0, 2.0 + 1.0j, 2.0 - 1.0j, -3.0, 0.5 + 2.0j,
                     0.5 - 2.0j])
    np.testing.assert_array_equal(leja_order(vals), j_leja_order(vals))
    sh = j_leja_order(vals)
    assert newton_basis_stages(sh, 6.0) == j_newton_basis_stages(sh, 6.0)
    with pytest.raises(ValueError, match="conjugate pairs"):
        newton_basis_stages([1.0 + 1.0j, 2.0], 6.0)
    jop, top, _ = problem((12, 10, 6), 1)
    assert estimate_opnorm(
        lambda v: spmv(top, v), top.n_rows_pad, torch.float64,
        device="cpu") == pytest.approx(j_estimate_opnorm(
            lambda v: j_spmv(jop, v), jop.n_rows_pad, jnp.float64),
        rel=1e-12)


def test_arnoldi_and_lanczos_match_jax():
    jop, top, b = problem((12, 10, 6), 3)
    jv, jh = j_arnoldi(lambda v: j_spmv(jop, v), jnp.asarray(b), 6)
    v, h = arnoldi(lambda u: spmv(top, u), torch.from_numpy(b), 6)
    assert v.shape == tuple(jv.shape) and h.shape == tuple(jh.shape)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-12)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-12)
    for which in ("LM", "LA", "SA"):
        jth, jvecs = j_lanczos_eigs(lambda u: j_spmv(jop, u),
                                    jnp.asarray(b), 3, m=24, which=which)
        th, vecs = lanczos_eigs(lambda u: spmv(top, u), torch.from_numpy(b),
                                3, m=24, which=which)
        np.testing.assert_allclose(th.numpy(), np.asarray(jth), rtol=1e-10)
        # eigh fixes each Ritz vector up to its sign
        jvecs = np.asarray(jvecs)
        sign = np.sign((vecs.numpy() * jvecs).sum(0))
        np.testing.assert_allclose(vecs.numpy() * sign, jvecs, atol=1e-9)
    with pytest.raises(ValueError, match="which"):
        lanczos_eigs(lambda u: spmv(top, u), torch.from_numpy(b), 2, m=4,
                     which="XX")


def test_error_paths():
    _, top, b = problem((12, 10, 6), 2)
    bt = torch.from_numpy(b)
    with pytest.raises(ValueError, match="fused"):
        tss(top, bt, basis_impl="fused", prec=lambda v: 0.25 * v)
    with pytest.raises(ValueError, match="fused"):
        tss(lambda v: spmv(top, v), bt, basis_impl="fused")
    with pytest.raises(ValueError, match="fused"):
        tss(top, bt, s=9, t_blocks=1, basis_impl="fused")
    with pytest.raises(ValueError, match="shifts"):
        tss(top, bt, s=4, shifts=[1.0, 2.0])
    with pytest.raises(ValueError, match="sigma"):
        tss(top, bt, powers_fn=lambda q, sig: q[:, None])
    with pytest.raises(ValueError, match="basis_impl"):
        tss(top, bt, basis_impl="unrolled")
