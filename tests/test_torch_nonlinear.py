"""Port parity: the nonlinear solvers (``trilinos_tpu_torch/nonlinear``:
JFNK Newton, Anderson, dogleg trust region, natural and pseudo-arclength
continuation) against the JAX package on every problem of
``tests/test_nonlinear.py``, float64 on the CPU.

The residuals apply Galeri Laplace2D 24² stored as DIA, through
``spmv(impl="xla")`` in the JAX package and through the port's
``dia_spmv``, whose derivative rule gives the JFNK operator its Jacobian
action. The same seeded numpy inputs go to both. Newton (or Anderson,
trust-region) iterations, total inner GMRES iterations, continuation points
and rejected steps must be equal, x (and an arclength point's parameter)
within 1e-10 (max |Δ|), and the
problem's own gates of ``tests/test_nonlinear.py`` hold for the port.
Each JAX solve runs once a module (an ``lru_cache``), under 20 s in all.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_thread  # noqa: F401  (autouse)
from trilinos_tpu import nonlinear as jnl
from trilinos_tpu.galeri import laplace2d as j_laplace2d
from trilinos_tpu.ops import formats as jF
from trilinos_tpu.ops import matvec as jS
from trilinos_tpu_torch.galeri import laplace2d
from trilinos_tpu_torch.nonlinear import (anderson, continuation,
                                          make_jvp_operator,
                                          make_vjp_operator, newton_krylov,
                                          newton_trust_region)
from trilinos_tpu_torch.ops import csr_to_dia, dia_spmv

X_TOL = 1e-10
NX = 24


@functools.lru_cache(maxsize=None)
def bratu(nx=NX):
    """Both packages' F(u) = A u - lam h² mask e^u (A: Laplace2D as DIA)
    and the host pieces: (jf, tf, n, npad, dense, h2)."""
    a = j_laplace2d(nx, nx)
    dev = jF.csr_to_dia(a)
    n, npad = a.shape[0], dev.n_rows_pad
    h2 = 1.0 / ((nx + 1) * (nx + 1))
    mask = np.zeros(npad)
    mask[:n] = 1.0
    mj, mt = jnp.asarray(mask), torch.from_numpy(mask)
    ta = csr_to_dia(laplace2d(nx, nx), device="cpu")
    assert ta.n_rows_pad == npad

    def jf(u, lam=4.0):
        return jS.spmv(dev, u, impl="xla") - lam * h2 * mj * jnp.exp(u)

    def tf(u, lam=4.0):
        return dia_spmv(ta, u) - lam * h2 * mt * torch.exp(u)

    return jf, tf, n, npad, a.to_dense(), h2


def zeros(npad):
    return jnp.zeros(npad), torch.zeros(npad, dtype=torch.float64)


def same(jres, tres):
    """Counts equal and x within X_TOL."""
    assert tres.iters == int(jres.iters)
    assert tres.inner_iters == int(jres.inner_iters)
    assert tres.converged == bool(jres.converged)
    assert np.abs(tres.x.numpy() - np.asarray(jres.x)).max() <= X_TOL


FORCINGS = ["type1", "type2", 1e-6]


@functools.lru_cache(maxsize=None)
def jax_newton(forcing):
    jf, _, _, npad, _, _ = bratu()
    return jnl.newton_krylov(jf, jnp.zeros(npad), rtol=0.0, atol=1e-10,
                             forcing=forcing)


def test_newton_bratu():
    """Type 1, type 2 and constant forcing."""
    for forcing in FORCINGS:
        _check_newton_bratu(forcing)


def _check_newton_bratu(forcing):
    _, tf, n, npad, dense, h2 = bratu()
    res = newton_krylov(tf, zeros(npad)[1], rtol=0.0, atol=1e-10,
                        forcing=forcing)
    same(jax_newton(forcing), res)
    assert res.converged and res.iters <= 12
    u = res.x.numpy()[:n]
    assert np.linalg.norm(dense @ u - 4.0 * h2 * np.exp(u)) <= 1e-9
    assert u.min() > 0


def arctan_x0():
    return np.random.default_rng(7).uniform(2.0, 5.0, 256)


@functools.lru_cache(maxsize=None)
def jax_arctan(linesearch, maxiter):
    return jnl.newton_krylov(jnp.arctan, jnp.asarray(arctan_x0()), rtol=0.0,
                             atol=1e-10, maxiter=maxiter,
                             linesearch=linesearch)


def test_linesearch_arctan():
    """The full step diverges from x0 in [2, 5]; both damped searches
    converge, with the JAX package's counts."""
    for linesearch, maxiter in (("full", 12), ("backtrack", 60),
                                ("polynomial", 60)):
        _check_arctan(linesearch, maxiter)


def _check_arctan(linesearch, maxiter):
    res = newton_krylov(torch.arctan, torch.from_numpy(arctan_x0()),
                        rtol=0.0, atol=1e-10, maxiter=maxiter,
                        linesearch=linesearch)
    jres = jax_arctan(linesearch, maxiter)
    assert res.iters == int(jres.iters)
    assert res.inner_iters == int(jres.inner_iters)
    assert res.converged == bool(jres.converged) == (linesearch != "full")
    if res.converged:
        assert np.abs(res.x.numpy() - np.asarray(jres.x)).max() <= X_TOL
        np.testing.assert_allclose(res.x.numpy(), 0.0, atol=1e-9)
    else:  # diverged: both iterates blow up the same way
        assert not np.isfinite(res.fnorm) or res.fnorm > 1.0


def test_jvp_and_vjp_operators_are_exact():
    """JFNK operator == the analytic Jacobian action, the VJP operator ==
    its transpose (the rule's transpose apply), to 1e-12."""
    _, tf, n, npad, dense, h2 = bratu()
    rng = np.random.default_rng(0)
    u = np.zeros(npad)
    u[:n] = rng.standard_normal(n)
    v = rng.standard_normal(npad)
    f3 = lambda y: tf(y, 3.0)
    jac = dense - np.diag(3.0 * h2 * np.exp(u[:n]))
    got = make_jvp_operator(f3, torch.from_numpy(u))(torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy()[:n], jac @ v[:n], rtol=1e-10,
                               atol=1e-12)
    vt = np.zeros(npad)
    vt[:n] = v[:n]
    op_t = make_vjp_operator(f3, torch.from_numpy(u))
    got_t = op_t(torch.from_numpy(vt))
    np.testing.assert_allclose(got_t.numpy()[:n], jac.T @ v[:n], rtol=1e-10,
                               atol=1e-12)
    assert torch.equal(op_t(torch.from_numpy(vt)), got_t)  # pullback reused


def contraction():
    rng = np.random.default_rng(1)
    n = 40
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return q @ np.diag(np.linspace(0.1, 0.9, n)) @ q.T, rng.standard_normal(n)


@functools.lru_cache(maxsize=None)
def jax_anderson():
    bm, c = contraction()
    lin = jnl.anderson(lambda x: jnp.asarray(bm) @ x + jnp.asarray(c),
                       jnp.zeros(len(c)), m=5, rtol=1e-10, maxiter=200)
    _, _, n, _, dense, h2 = bratu()
    ainv = jnp.asarray(np.linalg.inv(dense))
    g = lambda u: ainv @ (2.0 * h2 * jnp.exp(u))
    acc = jnl.anderson(g, jnp.zeros(n), m=4, rtol=0.0, atol=1e-12,
                       maxiter=100)
    pic = jnl.anderson(g, jnp.zeros(n), m=0, beta=1.0, rtol=0.0, atol=1e-12,
                       maxiter=100)
    return lin, acc, pic


def test_anderson_linear_contraction():
    bm, c = contraction()
    bt, ct = torch.from_numpy(bm), torch.from_numpy(c)
    res = anderson(lambda x: bt @ x + ct, torch.zeros(len(c),
                                                      dtype=torch.float64),
                   m=5, rtol=1e-10, maxiter=200)
    same(jax_anderson()[0], res)
    assert res.converged and res.iters < 80
    np.testing.assert_allclose(res.x.numpy(),
                               np.linalg.solve(np.eye(len(c)) - bm, c),
                               rtol=1e-6)


def test_anderson_bratu_picard():
    _, _, n, _, dense, h2 = bratu()
    ainv = torch.from_numpy(np.linalg.inv(dense))
    g = lambda u: ainv @ (2.0 * h2 * torch.exp(u))
    x0 = torch.zeros(n, dtype=torch.float64)
    res = anderson(g, x0, m=4, rtol=0.0, atol=1e-12, maxiter=100)
    pic = anderson(g, x0, m=0, beta=1.0, rtol=0.0, atol=1e-12, maxiter=100)
    _, jacc, jpic = jax_anderson()
    same(jacc, res)
    same(jpic, pic)
    u = res.x.numpy()
    assert np.linalg.norm(dense @ u - 2.0 * h2 * np.exp(u)) <= 1e-10
    assert res.iters <= pic.iters


@functools.lru_cache(maxsize=None)
def jax_trust_region():
    jf, _, _, npad, _, _ = bratu()
    br = jnl.newton_trust_region(jf, jnp.zeros(npad), rtol=0.0, atol=1e-9)
    rb = jnl.newton_trust_region(
        lambda z: jnp.stack([10.0 * (z[1] - z[0] ** 2), 1.0 - z[0]]),
        jnp.asarray([-1.2, 1.0]), rtol=0.0, atol=1e-12, maxiter=100,
        inner_restart=2)
    return br, rb


def test_trust_region_bratu():
    _, tf, n, npad, dense, h2 = bratu()
    res = newton_trust_region(tf, zeros(npad)[1], rtol=0.0, atol=1e-9)
    same(jax_trust_region()[0], res)
    u = res.x.numpy()[:n]
    assert res.converged
    assert np.linalg.norm(dense @ u - 4.0 * h2 * np.exp(u)) <= 1e-8


def test_trust_region_rosenbrock_residual():
    """The dogleg steers via the Cauchy direction (the VJP rule) from a
    bad start."""
    res = newton_trust_region(
        lambda z: torch.stack([10.0 * (z[1] - z[0] ** 2), 1.0 - z[0]]),
        torch.tensor([-1.2, 1.0], dtype=torch.float64), rtol=0.0,
        atol=1e-12, maxiter=100, inner_restart=2)
    same(jax_trust_region()[1], res)
    assert res.converged
    np.testing.assert_allclose(res.x.numpy(), [1.0, 1.0], atol=1e-8)


CONT_CASES = {"natural": dict(p_final=5.0, dp0=1.0, max_steps=40),
              "natural3": dict(p_final=3.0, dp0=0.5, max_steps=40),
              "arclength": dict(p_final=3.0, dp0=0.5, max_steps=60,
                                arclength=True)}


@functools.lru_cache(maxsize=None)
def jax_continuation(case):
    jf, _, _, npad, _, _ = bratu()
    return jnl.continuation(lambda u, lam: jf(u, lam), jnp.zeros(npad),
                            p0=0.0, newton_atol=1e-10, **CONT_CASES[case])


def port_continuation(case):
    _, tf, _, npad, _, _ = bratu()
    return continuation(lambda u, lam: tf(u, lam), zeros(npad)[1], p0=0.0,
                        newton_atol=1e-10, **CONT_CASES[case])


def same_path(jout, tout):
    assert tout.steps_failed == jout.steps_failed
    assert len(tout.params) == len(jout.params)
    # arclength points: the parameter is an unknown of the bordered
    # Newton solve, so it gets x's tolerance
    np.testing.assert_allclose(tout.params, jout.params, rtol=0, atol=X_TOL)
    for xj, xt in zip(jout.xs, tout.xs):
        assert np.abs(xt.numpy() - np.asarray(xj)).max() <= X_TOL


def test_continuation_natural():
    """Lower Bratu branch 0 -> 5: the same accepted points as the JAX
    package, ||u||_inf monotone in lambda."""
    out = port_continuation("natural")
    same_path(jax_continuation("natural"), out)
    assert out.params[-1] == pytest.approx(5.0, abs=1e-12)
    peaks = [float(torch.max(x)) for x in out.xs]
    assert all(b >= a - 1e-12 for a, b in zip(peaks, peaks[1:]))
    assert (out.fnorms[1:] <= 1e-8).all()


def test_continuation_arclength():
    """Pseudo-arclength (the bordered JFNK corrector) on the same branch:
    the JAX package's points, and the state of the natural path at the
    closest parameter."""
    nat = port_continuation("natural3")
    arc = port_continuation("arclength")
    same_path(jax_continuation("natural3"), nat)
    same_path(jax_continuation("arclength"), arc)
    assert arc.params[-1] >= 2.5
    n = bratu()[2]
    ia = int(np.argmin(np.abs(arc.params - nat.params[-1])))
    ref, got = nat.xs[-1].numpy()[:n], arc.xs[ia].numpy()[:n]
    lam_gap = abs(arc.params[ia] - nat.params[-1])
    if lam_gap < 0.26:
        assert np.linalg.norm(got - ref) <= 0.2 * max(
            np.linalg.norm(ref), 1e-12) + 0.3 * lam_gap
