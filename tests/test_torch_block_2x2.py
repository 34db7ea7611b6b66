"""The port's Teko 2×2 block operators and preconditioners against the
JAX package's.

The reference test's saddle-ish system (blocks 48 + 32, f64, dominant
diagonal blocks, seed 42): the blocked operator equals the dense matrix;
block Jacobi, block Gauss-Seidel (lower), SIMPLE with the exact Schur
complement and the Jacobi Schur approximation apply to 1e-12 of the
reference's; GMRES(40) with each takes the reference's iteration count to
rtol 1e-10, with the true residual at the tolerance. The LSC Schur
inverse is exact for F = c·I, and block LU with it converges in at most
five iterations, as in the reference.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trilinos_tpu.precond import block_2x2 as jprec
from trilinos_tpu.solvers import gmres as j_gmres

from trilinos_tpu_torch.precond import (BlockedOperator2x2,
                                        block_diagonal_prec,
                                        block_lower_triangular_prec,
                                        diag_schur_approx, lsc_inv_schur,
                                        simple_schur_2x2)
from trilinos_tpu_torch.solvers import gmres
from torch_threads import one_thread  # noqa: F401  (autouse)

N0, N1 = 48, 32


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def system():
    rng = np.random.default_rng(42)
    a00 = rng.standard_normal((N0, N0)) * 0.1 + 4 * np.eye(N0)
    a11 = rng.standard_normal((N1, N1)) * 0.1 + 3 * np.eye(N1)
    a01 = rng.standard_normal((N0, N1)) * 0.2
    a10 = rng.standard_normal((N1, N0)) * 0.2
    dense = np.block([[a00, a01], [a10, a11]])
    inv00, inv11 = np.linalg.inv(a00), np.linalg.inv(a11)
    schur_inv = np.linalg.inv(a11 - a10 @ inv00 @ a01)
    b = rng.standard_normal(N0 + N1)

    def pack(mod, asarray):
        m = {k: asarray(v) for k, v in dict(
            a00=a00, a01=a01, a10=a10, a11=a11, inv00=inv00, inv11=inv11,
            schur_inv=schur_inv, d11=1 / np.diag(a11),
            d00=1 / np.diag(a00)).items()}
        op = {k: (lambda mat: lambda v: mat @ v)(m[k])
              for k in ("a00", "a01", "a10", "a11", "inv00", "inv11",
                        "schur_inv")}
        blk = mod.BlockedOperator2x2(op["a00"], op["a01"], op["a10"],
                                     op["a11"], N0)
        precs = {
            "block diagonal": mod.block_diagonal_prec(op["inv00"],
                                                      op["inv11"], N0),
            "block lower triangular": mod.block_lower_triangular_prec(
                op["inv00"], blk.a10, op["inv11"], N0),
            "SIMPLE exact Schur": mod.simple_schur_2x2(
                op["inv00"], blk.a01, blk.a10, op["schur_inv"], N0),
            "SIMPLE diagonal Schur": mod.simple_schur_2x2(
                op["inv00"], blk.a01, blk.a10, mod.diag_schur_approx(
                    m["d11"], blk.a10, blk.a01, m["d00"]), N0)}
        return blk, precs

    import trilinos_tpu_torch.precond as tmod
    return (dense, b, pack(tmod, torch.from_numpy),
            pack(jprec, jnp.asarray))


def test_blocked_apply_matches_dense(system):
    dense, b, (blk, _), (jblk, _) = system
    got = blk(torch.from_numpy(b)).numpy()
    assert rel(got, dense @ b) <= 1e-13
    assert rel(got, jblk(jnp.asarray(b))) <= 1e-13
    assert isinstance(blk, BlockedOperator2x2)


@pytest.mark.parametrize("name", ["block diagonal", "block lower triangular",
                                  "SIMPLE exact Schur",
                                  "SIMPLE diagonal Schur"])
def test_block_prec_matches_jax(system, name):
    dense, b, (blk, precs), (jblk, jprecs) = system
    for shape in ((N0 + N1,), (N0 + N1, 3)):
        r = np.random.default_rng(7).standard_normal(shape)
        assert rel(precs[name](torch.from_numpy(r)).numpy(),
                   jprecs[name](jnp.asarray(r))) <= 1e-12
    res = gmres(blk, torch.from_numpy(b), prec=precs[name], restart=40,
                rtol=1e-10, maxiter=400)
    jres = j_gmres(jblk, jnp.asarray(b), prec=jprecs[name], restart=40,
                   rtol=1e-10, maxiter=400)
    assert bool(res.converged) and res.iters == int(jres.iters)
    x = res.x.numpy()
    assert np.linalg.norm(b - dense @ x) <= 1e-9 * np.linalg.norm(b)
    if name == "SIMPLE exact Schur":
        assert res.iters <= 5


def test_lsc_schur_exact_for_scaled_identity():
    rng = np.random.default_rng(8)
    n0, n1, c = 40, 12, 3.0
    bmat = torch.from_numpy(rng.standard_normal((n1, n0)))
    bbt_inv = torch.linalg.inv(bmat @ bmat.T)
    inv_s = lsc_inv_schur(lambda v: bbt_inv @ v, lambda v: bmat @ v,
                          lambda v: c * v, lambda v: bmat.T @ v)
    r1 = torch.from_numpy(rng.standard_normal(n1))
    want = torch.linalg.solve(-(1 / c) * bmat @ bmat.T, r1)
    assert rel(inv_s(r1).numpy(), want.numpy()) <= 1e-10
    blk = BlockedOperator2x2(lambda v: c * v, lambda v: bmat.T @ v,
                             lambda v: bmat @ v, lambda v: 0.0 * v, n0)
    prec = simple_schur_2x2(lambda v: v / c, blk.a01, blk.a10, inv_s, n0)
    b = torch.from_numpy(rng.standard_normal(n0 + n1))
    res = gmres(blk, b, prec=prec, restart=40, rtol=1e-10, maxiter=100)
    assert bool(res.converged) and res.iters <= 5
    assert callable(block_diagonal_prec(prec, prec, n0))
    assert callable(block_lower_triangular_prec(prec, prec, prec, n0))
    assert callable(diag_schur_approx(b, None, None, b))
