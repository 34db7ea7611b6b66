"""Port parity: block GMRES with the structured AMG against the JAX package.

The whole slice: Laplace3D as a matrix-free stencil, the structured SA-AMG
V-cycle as right preconditioner, block GMRES(25) with CGS2 (or DGKS)
projection and CholQR2 normalisation, nrhs seeded normal right-hand sides.
Both packages build their own hierarchy and solve from the same numpy
right-hand side on the CPU. In f64 at rtol 1e-8 they must take the same
number of block steps, converge in every column and agree in x to 1e-8
(max|Δ| / max|x|); with a bf16 basis within one block step; in f32 at rtol
1e-5 (the ``block_entry`` twin) within one block step and 1e-4.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trilinos_tpu.galeri import laplace3d as j_laplace3d
from trilinos_tpu.ops import spmv as j_spmv
from trilinos_tpu.precond import SaAmg as JSaAmg
from trilinos_tpu.solvers.block_gmres import block_gmres as j_block_gmres

from trilinos_tpu_torch.entry import block_entry
from trilinos_tpu_torch.galeri import laplace3d
from trilinos_tpu_torch.ops import (chol_inv_small, dia_spmm, dia_spmv, spmv,
                                    stencil_spmm, stencil_spmv)
from trilinos_tpu_torch.precond import SaAmg
from trilinos_tpu_torch.solvers import block_gmres

SETTINGS = dict(num_blocks=25, max_restarts=10)


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def rhs(op, nrhs, dtype):
    b = np.zeros((op.n_rows_pad, nrhs), dtype)
    b[:op.n_rows] = np.random.default_rng(0).standard_normal(
        (op.n_rows, nrhs))
    return b


@functools.lru_cache(maxsize=None)
def jax_solve(dims, nrhs, dtype, rtol, ortho="CGS2", basis_dtype=None):
    """The JAX package's solve, shared by the tests of one process:
    (b, x, block steps, converged)."""
    op = j_laplace3d(*dims, dtype=dtype, fmt="stencil")
    m = JSaAmg(op, {"dtype": dtype}).compute()
    st = m.state()
    b = rhs(op, nrhs, dtype)
    res = j_block_gmres(lambda v: j_spmv(op, v), jnp.asarray(b),
                        prec=lambda v: m.apply_state(st, v), rtol=rtol,
                        ortho=ortho, basis_dtype=basis_dtype, **SETTINGS)
    return b, np.asarray(res.x), int(res.iters), np.asarray(res.converged)


def port_solve(dims, b, rtol, **kw):
    op = laplace3d(*dims, dtype=b.dtype, fmt="stencil")
    m = SaAmg(op, {"dtype": b.dtype}, device="cpu").compute()
    st = m.state()
    return block_gmres(lambda v: spmv(op, v), torch.from_numpy(b),
                       prec=lambda v: m.apply_state(st, v), rtol=rtol,
                       **SETTINGS, **kw)


@pytest.mark.parametrize("dims,nrhs,ortho", [
    ((16, 16, 16), 16, "CGS2"),   # BASELINE config 5's solver at 16³
    ((10, 10, 8), 4, "CGS2"),     # 800 rows in 1024: padded rows
    ((10, 10, 8), 4, "DGKS"),
])
def test_f64_matches_jax(dims, nrhs, ortho):
    b, jx, jsteps, jconv = jax_solve(dims, nrhs, np.float64, 1e-8, ortho)
    res = port_solve(dims, b, 1e-8, ortho=ortho)
    assert bool(res.converged.all()) and jconv.all()
    assert res.iters == jsteps
    assert rel(res.x.numpy(), jx) <= 1e-8
    np.testing.assert_array_equal(res.x.numpy()[int(np.prod(dims)):], 0.0)


def test_bf16_basis_within_one_step_of_jax():
    b, _, jsteps, jconv = jax_solve((16, 16, 16), 16, np.float64, 1e-8,
                                    "CGS2", jnp.bfloat16)
    res = port_solve((16, 16, 16), b, 1e-8, basis_dtype=torch.bfloat16)
    assert bool(res.converged.all()) and jconv.all()
    assert abs(res.iters - jsteps) <= 1
    assert res.x.dtype == torch.float64


@pytest.mark.parametrize("dtype,max_dsteps,tol", [
    (np.float64, 0, 1e-8), (np.float32, 1, 1e-4)])
def test_block_entry_twin_matches_jax(dtype, max_dsteps, tol):
    counters = (stencil_spmv, stencil_spmm, dia_spmv, dia_spmm,
                chol_inv_small)
    for c in counters:
        c.launches = 0
    step, (b, state) = block_entry(dtype=dtype, device="cpu")
    jb, jx, jsteps, jconv = jax_solve((16, 16, 16), 16, dtype, 1e-5)
    np.testing.assert_array_equal(b.numpy(), jb)
    res = step(b, state)
    assert bool(res.converged.all()) and jconv.all()
    assert abs(res.iters - jsteps) <= max_dsteps
    assert rel(res.x.numpy(), jx) <= tol
    assert res.x.dtype == b.dtype
    # on the CPU every wrapper ran its plain version: no kernel launched
    assert all(c.launches == 0 for c in counters)


@pytest.mark.parametrize("ortho", ["MGS", "IMGS"])
def test_mgs_orthogonalization_raises(ortho):
    b = torch.zeros((16, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="CGS2/ICGS/DGKS"):
        block_gmres(lambda v: v, b, ortho=ortho)


def test_one_dimensional_rhs_raises():
    with pytest.raises(ValueError, match="2-D"):
        block_gmres(lambda v: v, torch.ones(16, dtype=torch.float64))


def test_identity_operator_and_zero_column():
    """A = I converges in one block step; a zero right-hand-side column
    stays zero (the CholQR floor keeps its basis column at 0)."""
    b = np.random.default_rng(3).standard_normal((64, 3))
    b[:, 1] = 0.0
    res = block_gmres(lambda v: v, torch.from_numpy(b), rtol=1e-10)
    assert bool(res.converged.all()) and res.iters == 1
    assert rel(res.x.numpy(), b) <= 1e-12
    np.testing.assert_array_equal(res.x.numpy()[:, 1], 0.0)
