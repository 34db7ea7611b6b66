"""Port parity: the optimizers (``trilinos_tpu_torch/optim``: trust-region
Newton-CG, L-BFGS, spectral projected gradient, augmented Lagrangian)
against the JAX package's ``optim`` on the zoo of ``tests/test_optim.py``
and ``tests/test_auglag.py``, float64 on the CPU.

The same objectives (the ROL zoo's Rosenbrock, seeded quadratics, the
nonconvex saddle, the constrained problems) written in jnp and in torch
go through both packages: iterations, inner iterations (truncated-CG
steps, line-search evaluations, inner trust-region iterations) must be
equal and x within 1e-10 (max |Δ|), and the JAX tests' gates hold for the
port. The JAX tests' float32 quadratics run here in float64 in both
packages; the float32 noise-floor case runs on the port alone with the
JAX test's gate (XLA and torch round float32 differently, so its counts
are not held). The JAX package's compile-cache identity test has no
counterpart: the port compiles nothing.
"""
import functools

import jax.numpy as jnp
import numpy as np
import torch

from torch_threads import one_thread  # noqa: F401  (autouse)
from trilinos_tpu import optim as jopt
from trilinos_tpu_torch.optim import (augmented_lagrangian, lbfgs,
                                      projected_gradient, trust_region_newton)

X_TOL = 1e-10
F64 = torch.float64


def rosenbrock(xp):
    """The ROL zoo's Rosenbrock (ROL_Rosenbrock.hpp), any even dim."""
    return lambda x: xp.sum(100.0 * (x[1::2] - x[::2] ** 2) ** 2
                            + (1.0 - x[::2]) ** 2)


def quadratic(n, cond=100.0, seed=0):
    rng = np.random.default_rng(seed)
    d = np.logspace(0, np.log10(cond), n)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = q @ np.diag(d) @ q.T
    b = rng.standard_normal(n)
    aj, bj = jnp.asarray(a), jnp.asarray(b)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    return ((lambda x: 0.5 * x @ (aj @ x) - bj @ x),
            (lambda x: 0.5 * x @ (at @ x) - bt @ x),
            np.linalg.solve(a, b))


def saddle(xp):
    return lambda x: x[0] ** 4 - x[0] ** 2 + 0.5 * x[1] ** 2


def problem(name):
    """(JAX objective, port objective, x0 as numpy, known solution)."""
    if name.startswith("quad"):
        n, cond = {"quad64": (64, 100.0), "quad16": (16, 10.0)}[name]
        jo, to, xs = quadratic(n, cond)
        return jo, to, np.zeros(n), xs
    if name == "rosen2":
        return rosenbrock(jnp), rosenbrock(torch), np.array([-1.2, 1.0]), 1.0
    if name == "rosen100":
        return rosenbrock(jnp), rosenbrock(torch), np.full(100, -1.2), 1.0
    if name == "saddle":
        return saddle(jnp), saddle(torch), np.array([1e-3, 1.0]), None
    if name == "quartic":
        return ((lambda x: jnp.sum((x - 0.5) ** 4 + x ** 2)),
                (lambda x: torch.sum((x - 0.5) ** 4 + x ** 2)),
                np.zeros(8), None)
    raise KeyError(name)


def same(jres, tres):
    assert tres.iters == jres.iters
    assert tres.inner_iters == jres.inner_iters
    assert tres.converged == jres.converged
    assert np.abs(tres.x.numpy() - np.asarray(jres.x)).max() <= X_TOL


TR_CASES = {"quad64": dict(gtol=1e-4), "rosen2": dict(gtol=1e-6,
                                                      maxiter=200),
            "rosen100": dict(gtol=1e-8, maxiter=300),
            "saddle": dict(gtol=1e-6)}


@functools.lru_cache(maxsize=None)
def jax_tr(name):
    jo, _, x0, _ = problem(name)
    return jopt.trust_region_newton(jo, jnp.asarray(x0), **TR_CASES[name])


def test_trust_region_newton():
    """Truncated CG on forward-over-reverse Hessian actions, each problem
    of TR_CASES: the JAX package's outer and CG iterations; the saddle
    start must escape along negative curvature to |x0| = 1/√2."""
    for name in TR_CASES:
        _check_trust_region(name)


def _check_trust_region(name):
    _, to, x0, xs = problem(name)
    res = trust_region_newton(to, torch.from_numpy(x0), **TR_CASES[name])
    same(jax_tr(name), res)
    assert res.converged
    x = res.x.numpy()
    if name == "quad64":
        assert np.linalg.norm(x - xs) < 1e-3
    elif name == "saddle":
        assert abs(abs(x[0]) - np.sqrt(0.5)) < 1e-3
    else:
        assert np.allclose(x, 1.0, atol=1e-6 if name == "rosen100"
                           else 1e-4)


def test_trust_region_rosenbrock_f32_floor():
    """float32: the gradient noise floor of this objective is ~2e-4; the
    solver reaches the solution though gnorm cannot reach f64 levels."""
    x0 = torch.full((100,), -1.2, dtype=torch.float32)
    res = trust_region_newton(rosenbrock(torch), x0, gtol=5e-4, maxiter=300)
    assert np.allclose(res.x.numpy(), 1.0, atol=1e-3)


LB_CASES = {"quad64": dict(gtol=1e-4, maxiter=400),
            "rosen2": dict(gtol=1e-5, maxiter=400),
            "quad16": dict(memory=1, gtol=1e-4, maxiter=500),
            "quartic": dict(gtol=1e-6, maxiter=200)}


@functools.lru_cache(maxsize=None)
def jax_lbfgs(name):
    jo, _, x0, _ = problem(name)
    return jopt.lbfgs(jo, jnp.asarray(x0), **LB_CASES[name])


def test_lbfgs():
    """Two-loop recursion over the stored pairs and the strong-Wolfe
    search, each problem of LB_CASES: the JAX package's iterations and
    line-search evaluations."""
    for name in LB_CASES:
        _check_lbfgs(name)


def _check_lbfgs(name):
    _, to, x0, xs = problem(name)
    res = lbfgs(to, torch.from_numpy(x0), **LB_CASES[name])
    same(jax_lbfgs(name), res)
    assert res.converged and res.gnorm <= LB_CASES[name]["gtol"]
    if name == "quad64":
        assert np.linalg.norm(res.x.numpy() - xs) < 2e-3
    elif name == "rosen2":
        assert np.allclose(res.x.numpy(), 1.0, atol=1e-3)


def pg_case(name):
    """(JAX objective, port objective, x0, lower, upper, kw, solution)."""
    if name == "active":
        c = np.random.default_rng(1).uniform(-1.0, 2.0, 32)
        cj, ct = jnp.asarray(c), torch.from_numpy(c)
        return (lambda x: 0.5 * jnp.sum((x - cj) ** 2),
                lambda x: 0.5 * torch.sum((x - ct) ** 2), np.full(32, 0.5),
                0.0, 1.0, dict(gtol=1e-5), np.clip(c, 0.0, 1.0))
    if name == "interior":
        jo, to, xs = quadratic(16, 10.0)
        return jo, to, np.zeros(16), -10.0, 10.0, dict(gtol=1e-4,
                                                       maxiter=3000), xs
    return (lambda x: jnp.sum(x ** 2), lambda x: torch.sum(x ** 2),
            np.full(4, 5.0), 1.0, 2.0, dict(gtol=1e-6), np.ones(4))


PG_CASES = ["active", "interior", "outside"]


@functools.lru_cache(maxsize=None)
def jax_pg(name):
    jo, _, x0, lo, hi, kw, _ = pg_case(name)
    return jopt.projected_gradient(jo, jnp.asarray(x0), lo, hi, **kw)


def test_projected_gradient():
    """Spectral projected gradient on the box, each case of PG_CASES: the
    JAX package's iterations and trial evaluations, the closed-form
    solutions."""
    for name in PG_CASES:
        _check_projected_gradient(name)


def _check_projected_gradient(name):
    _, to, x0, lo, hi, kw, xs = pg_case(name)
    res = projected_gradient(to, torch.from_numpy(x0), lo, hi, **kw)
    same(jax_pg(name), res)
    assert res.converged
    tol = {"active": 1e-4, "interior": 2e-3, "outside": 1e-5}[name]
    assert np.abs(res.x.numpy() - xs).max() < tol


def al_case(name):
    """(JAX obj, JAX con, port obj, port con, x0, kw)."""
    if name == "kkt":
        rng = np.random.default_rng(0)
        n, m = 8, 3
        q = rng.standard_normal((n, n))
        q = q @ q.T + n * np.eye(n)
        b, a = rng.standard_normal(n), rng.standard_normal((m, n))
        d = rng.standard_normal(m)
        J = [jnp.asarray(v) for v in (q, b, a, d)]
        T = [torch.from_numpy(v) for v in (q, b, a, d)]
        return (lambda x: 0.5 * x @ (J[0] @ x) - J[1] @ x,
                lambda x: J[2] @ x - J[3],
                lambda x: 0.5 * x @ (T[0] @ x) - T[1] @ x,
                lambda x: T[2] @ x - T[3], np.zeros(n),
                dict(ctol=1e-10, gtol=1e-10))
    if name == "circle":
        rosen = lambda x: (1 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2
        return (rosen, lambda x: jnp.atleast_1d(x @ x - 1.0), rosen,
                lambda x: torch.atleast_1d(x @ x - 1.0), np.array([0.5, 0.5]),
                dict(ctol=1e-10, gtol=1e-8))
    if name == "two":
        p = np.array([3.0, -1.0, 2.0])
        pj, pt = jnp.asarray(p), torch.from_numpy(p)
        return (lambda x: 0.5 * jnp.vdot(x - pj, x - pj),
                lambda x: jnp.asarray([jnp.sum(x) - 1.0, x[0] - x[1]]),
                lambda x: 0.5 * torch.vdot(x - pt, x - pt),
                lambda x: torch.stack([torch.sum(x) - 1.0, x[0] - x[1]]),
                np.zeros(3), dict(ctol=1e-10, gtol=1e-10))
    return (lambda x: jnp.vdot(x, x),
            lambda x: jnp.atleast_1d(x[0] ** 2 + 1.0),
            lambda x: torch.vdot(x, x),
            lambda x: torch.atleast_1d(x[0] ** 2 + 1.0), np.ones(2),
            dict(maxouter=6))


AL_CASES = ["kkt", "circle", "two", "infeasible"]


@functools.lru_cache(maxsize=None)
def jax_al(name):
    jo, jc, _, _, x0, kw = al_case(name)
    return jopt.augmented_lagrangian(jo, jc, jnp.asarray(x0), **kw)


def test_augmented_lagrangian():
    """Each case of AL_CASES: outer iterations, inner trust-region
    iterations, x and the multipliers as the JAX package; the JAX tests'
    KKT, circle and projection solutions; an unreachable constraint is not
    converged."""
    for name in AL_CASES:
        _check_augmented_lagrangian(name)


def _check_augmented_lagrangian(name):
    _, _, to, tc, x0, kw = al_case(name)
    res, lam = augmented_lagrangian(to, tc, torch.from_numpy(x0), **kw)
    jres, jlam = jax_al(name)
    same(jres, res)
    assert np.abs(lam.numpy() - np.asarray(jlam)).max() <= 1e-8 * max(
        1.0, np.abs(np.asarray(jlam)).max())
    x = res.x.numpy()
    if name == "infeasible":
        assert not res.converged
        return
    assert res.converged
    if name == "circle":
        assert abs(x @ x - 1.0) < 1e-9
        np.testing.assert_allclose(x, [0.7864, 0.6177], atol=1e-3)
    elif name == "two":
        a = np.array([[1.0, 1, 1], [1, -1, 0]])
        kkt = np.block([[np.eye(3), a.T], [a, np.zeros((2, 2))]])
        sol = np.linalg.solve(kkt, np.array([3.0, -1.0, 2.0, 1.0, 0.0]))
        np.testing.assert_allclose(x, sol[:3], atol=1e-7)
