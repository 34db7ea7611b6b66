"""The port's compensated (double-single) reductions against the JAX
package's and against f64 oracles.

Twins of ``tests/test_compensated.py``: two_sum and two_prod are exact
(their error terms are exact in f32 and in f64, which only holds with no
multiply-add contracted into an FMA), the compensated tree sum, Dot2 beats
the plain dot, cancellation, columnwise dots, and the JAX package's
``comp_dot``/``comp_sum`` on the same inputs. The GMRES wiring is in
``tests/test_torch_gmres.py``.
"""
from fractions import Fraction

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trilinos_tpu.ops import compensated as JC

from trilinos_tpu_torch.ops import compensated as C
from trilinos_tpu_torch.parallel.comm import SerialComm
from torch_threads import one_thread  # noqa: F401  (autouse)


def f32(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def test_two_sum_exact(rng):
    a = f32(rng.standard_normal(1000) * 1e6)
    b = f32(rng.standard_normal(1000))
    s, e = C.two_sum(a, b)
    np.testing.assert_array_equal(a.double() + b.double(),
                                  s.double() + e.double())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_two_prod_error_term_exact(rng, dtype):
    """p + e equals a·b exactly: checked in f64 for f32 operands and in
    exact rational arithmetic for f64 operands."""
    a = rng.standard_normal(300).astype(dtype) * 7.3
    b = rng.standard_normal(300).astype(dtype)
    p, e = C.two_prod(torch.from_numpy(a), torch.from_numpy(b))
    p, e = p.numpy(), e.numpy()
    if dtype == np.float32:
        np.testing.assert_array_equal(a.astype(np.float64) * b,
                                      p.astype(np.float64) + e)
    else:
        for ai, bi, pi, ei in zip(a, b, p, e):
            assert Fraction(float(ai)) * Fraction(float(bi)) == (
                Fraction(float(pi)) + Fraction(float(ei)))
    # the same values as the JAX package's transform
    jp, je = JC.two_prod(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(p, np.asarray(jp))
    np.testing.assert_array_equal(e, np.asarray(je))


@pytest.mark.parametrize("n", [1, 2, 3, 7, 1000, 4097])
def test_comp_sum_sizes(rng, n):
    x = f32(rng.standard_normal(n))
    hi, lo = C.comp_sum(x)
    exact = float(x.double().sum())
    got = float(hi.double() + lo.double())
    assert abs(got - exact) <= 4 * np.finfo(np.float32).eps * max(
        abs(exact), float(x.abs().sum()) * 1e-3)
    jhi, jlo = JC.comp_sum(jnp.asarray(x.numpy()))
    assert float(jhi) + float(jlo) == pytest.approx(got, abs=1e-6)


def test_comp_dot_is_the_rounded_exact_dot(rng):
    """Dot2 in f32 lands within half an ulp of the exact dot (only its
    final rounding), and beats XLA's plain f32 dot 50× as in the JAX
    package's test. (torch's own plain dot sums blockwise and reads about
    20 ulps here, so the 50× is held against the reference's dot.)"""
    n = 100_000
    xn = rng.standard_normal(n).astype(np.float32)
    yn = rng.standard_normal(n).astype(np.float32)
    exact = float(xn.astype(np.float64) @ yn.astype(np.float64))
    comp = float(C.comp_dot_global(SerialComm(), f32(xn), f32(yn)))
    assert abs(comp - exact) <= 0.5 * float(np.spacing(np.float32(abs(exact))))
    plain_xla = float(jnp.dot(jnp.asarray(xn), jnp.asarray(yn)))
    assert abs(comp - exact) * 50 <= max(abs(plain_xla - exact),
                                         abs(exact) * 1e-9)


def test_comp_dot_cancellation(rng):
    body = rng.standard_normal(10_000)
    x = f32(np.concatenate([[1e8], body, [-1e8]]))
    exact = float(x.double().sum())
    comp = float(C.comp_dot_global(SerialComm(), x, torch.ones_like(x)))
    assert abs(comp - exact) < 1e-2
    assert abs(float(x.sum()) - exact) > 1e-1  # plain genuinely loses here


def test_comp_dot_columnwise_and_matches_jax(rng):
    xn = rng.standard_normal((500, 3)).astype(np.float32)
    yn = rng.standard_normal((500, 3)).astype(np.float32)
    got = C.comp_dot_global(SerialComm(), f32(xn), f32(yn)).numpy()
    exact = np.einsum("nk,nk->k", xn.astype(np.float64), yn)
    np.testing.assert_allclose(got, exact, rtol=1e-6)
    hi, lo = C.comp_dot(f32(xn), f32(yn))
    jhi, jlo = JC.comp_dot(jnp.asarray(xn), jnp.asarray(yn))
    np.testing.assert_allclose(hi.double() + lo.double(),
                               np.asarray(jhi, np.float64) + np.asarray(jlo),
                               rtol=1e-7)
    norm = C.comp_norm2(SerialComm(), f32(xn))
    np.testing.assert_allclose(norm.numpy(), np.linalg.norm(
        xn.astype(np.float64), axis=0), rtol=1e-7)


def test_rejects_other_dtypes():
    with pytest.raises(TypeError, match="f32/f64"):
        C.two_prod(torch.ones(3, dtype=torch.bfloat16),
                   torch.ones(3, dtype=torch.bfloat16))
