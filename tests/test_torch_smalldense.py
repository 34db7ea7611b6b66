"""Port parity: the small Cholesky factor and inverse against the JAX package.

The same seeded SPD matrices go through ``trilinos_tpu.ops.smalldense``
(its unrolled jnp pair in f64, its Pallas kernel in interpret mode in f32)
and through ``trilinos_tpu_torch.ops.smalldense`` on the CPU, where
``chol_inv_small`` runs its plain version. Tolerances are max|Δ| / max|ref|:
1e-12 in f64 (the same unrolled arithmetic, summed by different BLAS), 1e-5
in f32 (the Pallas kernel sums its lane reductions in another order).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trilinos_tpu.ops import smalldense as jsd

from trilinos_tpu_torch.ops import smalldense as tsd


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def spd(k, dtype, seed):
    """Gram matrix of a random (4k, k) panel: SPD, well conditioned."""
    a = np.random.default_rng(seed).standard_normal((4 * k, k))
    return (a.T @ a).astype(dtype)


@pytest.mark.parametrize("k", [1, 2, 5, 16, 32])
def test_f64_matches_jax_unrolled(k):
    g = spd(k, np.float64, seed=k)
    jl, jlinv = jsd.chol_inv_small(jnp.asarray(g))
    l, linv = tsd.chol_inv_small(torch.from_numpy(g))
    assert l.dtype == torch.float64
    assert rel(l.numpy(), jl) <= 1e-12
    assert rel(linv.numpy(), jlinv) <= 1e-12
    np.testing.assert_array_equal(np.triu(l.numpy(), 1), 0.0)
    np.testing.assert_array_equal(np.triu(linv.numpy(), 1), 0.0)
    assert rel(l.numpy() @ l.numpy().T, g) <= 1e-13
    assert tsd.chol_inv_small.launches == 0  # the CPU runs the plain version


@pytest.mark.parametrize("k", [1, 3, 8, 16, 17, 32])
def test_f32_matches_jax_pallas_interpret(k):
    g = spd(k, np.float32, seed=100 + k)
    jl, jlinv = jsd.chol_inv_small(jnp.asarray(g), interpret=True)
    l, linv = tsd.chol_inv_small(torch.from_numpy(g))
    assert l.dtype == torch.float32
    assert rel(l.numpy(), jl) <= 1e-5
    assert rel(linv.numpy(), jlinv) <= 1e-5


def test_k33_takes_the_library_branch():
    g = spd(33, np.float64, seed=33)
    l, linv = tsd.chol_inv_small(torch.from_numpy(g))
    np.testing.assert_array_equal(
        l.numpy(), torch.linalg.cholesky(torch.from_numpy(g)).numpy())
    jl, jlinv = jsd.chol_inv_small(jnp.asarray(g))
    assert rel(l.numpy(), jl) <= 1e-12
    assert rel(linv.numpy(), jlinv) <= 1e-12


@pytest.mark.parametrize("lower", [False, True])
def test_tri_inv_small_matches_jax(lower):
    a = np.random.default_rng(7).standard_normal((12, 12)) + 4 * np.eye(12)
    r = np.tril(a) if lower else np.triu(a)
    got = tsd.tri_inv_small(torch.from_numpy(r), lower=lower).numpy()
    assert rel(got, jsd.tri_inv_small(jnp.asarray(r), lower=lower)) <= 1e-12
    assert rel(got @ r, np.eye(12)) <= 1e-12


def test_chol_solve_small_matches_jax():
    g = spd(8, np.float64, seed=8)
    rhs = np.random.default_rng(9).standard_normal((8, 3))
    got = tsd.chol_solve_small(torch.from_numpy(g),
                               torch.from_numpy(rhs)).numpy()
    assert rel(got, jsd.chol_solve_small(jnp.asarray(g),
                                         jnp.asarray(rhs))) <= 1e-12
    assert rel(g @ got, rhs) <= 1e-12


def test_wrapper_checks():
    with pytest.raises(ValueError, match="square"):
        tsd.chol_inv_small(torch.zeros((3, 4), dtype=torch.float64))
    with pytest.raises(ValueError, match="not supported"):
        tsd.chol_inv_small(torch.eye(4, device="meta"))
