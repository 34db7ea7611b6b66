"""Port parity: the analysis drivers (``trilinos_tpu_torch/piro.py``: steady
solves with adjoint sensitivities, the transient driver, black-box
coupling, reduced-space optimization) against the JAX package's
``piro.py`` on the problems of ``tests/test_piro.py``, float64 on the CPU.

Newton and GMRES counts, integrator steps, coupling sweeps and optimizer
iterations must be equal, states and parameters within 1e-10 (max |Δ|),
the adjoint dg/dp within 1e-10 of the JAX package's and within 1e-5 of a
central finite difference. Every JAX solve compiles its Newton pieces
anew (its ``solve_steady`` hands Newton a fresh closure), about a second a
steady solve here, so the optimizer references are cut to keep each shared
JAX computation near 20 s: the unconstrained analysis is held to the JAX
package over its first three iterations, the constrained one (n = 6, not
``test_budgeted_source_fit``'s 12) over its first outer iteration of three
inner ones; the port then runs both to convergence with the JAX tests'
gates.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

from torch_threads import one_thread  # noqa: F401  (autouse)
from trilinos_tpu import piro as jpiro
from trilinos_tpu.galeri import laplace2d as j_laplace2d
from trilinos_tpu.ops import choose_format as j_choose_format
from trilinos_tpu.ops import spmv as j_spmv
from trilinos_tpu_torch import piro
from trilinos_tpu_torch.galeri import laplace2d
from trilinos_tpu_torch.nonlinear import newton_krylov
from trilinos_tpu_torch.ops import choose_format, spmv

X_TOL = 1e-10
F64 = torch.float64


def t(a):
    return torch.tensor(a, dtype=F64)


def bratu_models(n=12):
    """1-D Bratu f(u, p) = -u'' - p[0] e^u - p[1] x with the quadratic
    mismatch response, in both packages: (JAX Model, port Model)."""
    h = 1.0 / (n + 1)
    xj = jnp.linspace(h, 1 - h, n)
    xt = torch.from_numpy(np.asarray(xj))
    tj, tt = jnp.sin(jnp.pi * xj) * 0.1, torch.sin(torch.pi * xt) * 0.1

    def jres(u, p):
        up = jnp.concatenate([jnp.zeros(1), u, jnp.zeros(1)])
        return (2 * up[1:-1] - up[:-2] - up[2:]) / h / h - p[0] * jnp.exp(
            u) - p[1] * xj

    def tres(u, p):
        z = torch.zeros(1, dtype=u.dtype)
        up = torch.cat([z, u, z])
        return (2 * up[1:-1] - up[:-2] - up[2:]) / h / h - p[0] * torch.exp(
            u) - p[1] * xt

    return (jpiro.Model(jres, lambda u, p: 0.5 * jnp.sum((u - tj) ** 2)),
            piro.Model(tres, lambda u, p: 0.5 * torch.sum((u - tt) ** 2)))


@functools.lru_cache(maxsize=None)
def jax_steady():
    jm, _ = bratu_models()
    plain = jpiro.solve_steady(jm, jnp.zeros(12), jnp.array([1.0, 0.5]),
                               rtol=1e-12)
    sens = jpiro.solve_steady(jm, jnp.zeros(12), jnp.array([0.8, 0.3]),
                              sensitivities=True, rtol=1e-13,
                              adjoint_rtol=1e-12)
    return plain, sens


def test_solve_and_response():
    _, tm = bratu_models()
    r = piro.solve_steady(tm, torch.zeros(12, dtype=F64), t([1.0, 0.5]),
                          rtol=1e-12)
    jr = jax_steady()[0]
    assert r.converged and r.iters == jr.iters
    assert np.abs(r.u.numpy() - np.asarray(jr.u)).max() <= X_TOL
    assert float(torch.linalg.norm(tm.residual(r.u, t([1.0, 0.5])))) < 1e-9
    assert abs(float(r.g) - float(jr.g)) <= 1e-12 and float(r.g) >= 0


def test_adjoint_sensitivity():
    """dg/dp through the VJP adjoint: the JAX package's to 1e-10 and a
    central finite difference of the port's own solves to 1e-5."""
    _, tm = bratu_models()
    p = np.array([0.8, 0.3])
    r = piro.solve_steady(tm, torch.zeros(12, dtype=F64), t(p),
                          sensitivities=True, rtol=1e-13, adjoint_rtol=1e-12)
    jr = jax_steady()[1]
    assert r.converged and r.iters == jr.iters
    np.testing.assert_allclose(r.dgdp.numpy(), np.asarray(jr.dgdp),
                               rtol=0, atol=X_TOL)
    eps = 1e-6
    fd = np.zeros(2)
    for k in range(2):
        gs = []
        for sgn in (1, -1):
            pk = p.copy()
            pk[k] += sgn * eps
            gs.append(float(piro.solve_steady(tm, r.u, t(pk),
                                              rtol=1e-13).g))
        fd[k] = (gs[0] - gs[1]) / (2 * eps)
    np.testing.assert_allclose(r.dgdp.numpy(), fd, rtol=1e-5, atol=1e-10)


@functools.lru_cache(maxsize=None)
def transient_case():
    """du/dt = -0.5 K u on Laplace2D 5² through both packages'
    ``choose_format`` (DIA) and the seeded u0."""
    ja, ta = j_laplace2d(5, 5), laplace2d(5, 5)
    jdev, tdev = j_choose_format(ja), choose_format(ta, device="cpu")
    n, npad = ja.shape[0], jdev.n_rows_pad
    u0 = np.zeros(npad)
    u0[:n] = np.random.default_rng(0).standard_normal(n)
    jm = jpiro.Model(lambda u, p: p[0] * j_spmv(jdev, u),
                     lambda u, p: jnp.sum(u[:n] ** 2))
    jres, jg = jpiro.solve_transient(jm, jnp.asarray(u0), jnp.array([0.5]),
                                     0.0, 0.1, 1e-3, rtol=1e-7, atol=1e-10)
    tm = piro.Model(lambda u, p: p[0] * spmv(tdev, u),
                    lambda u, p: torch.sum(u[:n] ** 2))
    return ja.to_dense(), n, u0, tm, jres, float(jg)


def test_transient_linear_decay():
    dense, n, u0, tm, jres, jg = transient_case()
    res, g = piro.solve_transient(tm, torch.from_numpy(u0), t([0.5]), 0.0,
                                  0.1, 1e-3, rtol=1e-7, atol=1e-10)
    assert (res.steps, res.rejected, res.newton_iters) == (
        jres.steps, jres.rejected, jres.newton_iters)
    assert np.abs(res.u.numpy() - np.asarray(jres.u)).max() <= X_TOL
    assert abs(float(g) - jg) <= 1e-10 * abs(jg)
    want = sla.expm(-0.05 * dense) @ u0[:n]
    np.testing.assert_allclose(res.u.numpy()[:n], want, atol=5e-5)
    np.testing.assert_allclose(float(g), np.sum(want ** 2), rtol=1e-3)


def coupled_models(xp, n, mode):
    """The two-field systems of ``tests/test_piro.py`` with the array
    module ``xp``: (models, couplers)."""
    h = 1.0 / (n + 1)
    if xp is jnp:
        mod, cat, z = jpiro, jnp.concatenate, jnp.zeros(1)
        xs = jnp.linspace(h, 1 - h, n)
    else:
        mod, cat, z = piro, torch.cat, torch.zeros(1, dtype=F64)
        xs = torch.linspace(h, 1 - h, n, dtype=F64)

    def lap(u):
        up = cat([z, u, z])
        return (2 * up[1:-1] - up[:-2] - up[2:]) / h / h

    if mode == "seidel":
        models = [mod.Model(lambda u, p: lap(u) + 0.5 * u ** 3 - p
                            - xp.sin(np.pi * xs)),
                  mod.Model(lambda v, p: lap(v) - p)]
        couplers = [lambda s: 2.0 * s[1], lambda s: 3.0 * s[0]]
    else:
        models = [mod.Model(lambda u, p: lap(u) - p - 1.0),
                  mod.Model(lambda v, p: lap(v) - p)]
        couplers = [lambda s: s[1], lambda s: s[0]]
    return models, couplers


COUPLED = {"seidel": (16, dict(tol=1e-12, maxiter=60)),
           "jacobi": (8, dict(tol=1e-11, maxiter=80, mode="jacobi"))}


@functools.lru_cache(maxsize=None)
def jax_coupled(mode):
    n, kw = COUPLED[mode]
    models, couplers = coupled_models(jnp, n, mode)
    return jpiro.solve_coupled(models, [jnp.zeros(n)] * 2, couplers, **kw)


@pytest.mark.parametrize("mode", ["seidel", "jacobi"])
def test_coupled(mode):
    """Block Gauss-Seidel and block Jacobi sweeps: the JAX package's sweep
    count and states; Gauss-Seidel also against the monolithic Newton
    solve of the stacked residual."""
    n, kw = COUPLED[mode]
    models, couplers = coupled_models(torch, n, mode)
    res = piro.solve_coupled(models, [torch.zeros(n, dtype=F64)] * 2,
                             couplers, **kw)
    jres = jax_coupled(mode)
    assert res.converged and jres.converged and res.iters == jres.iters
    for sj, st in zip(jres.states, res.states):
        assert np.abs(st.numpy() - np.asarray(sj)).max() <= X_TOL
    if mode == "seidel":
        def mono(w):
            u, v = w[:n], w[n:]
            return torch.cat([models[0].residual(u, 2.0 * v),
                              models[1].residual(v, 3.0 * u)])
        m = newton_krylov(mono, torch.zeros(2 * n, dtype=F64), rtol=1e-13)
        np.testing.assert_allclose(res.states[0].numpy(), m.x[:n].numpy(),
                                   atol=1e-9)
        np.testing.assert_allclose(res.states[1].numpy(), m.x[n:].numpy(),
                                   atol=1e-9)


def fit_models(n):
    """Both packages' fit of the Bratu state generated at p_true =
    (0.6, 0.8)."""
    jm, tm = bratu_models(n)
    p_true = np.array([0.6, 0.8])
    jtruth = jpiro.solve_steady(jm, jnp.zeros(n), jnp.asarray(p_true),
                                rtol=1e-13)
    ttruth = piro.solve_steady(tm, torch.zeros(n, dtype=F64), t(p_true),
                               rtol=1e-13)
    return (jpiro.Model(jm.residual,
                        lambda u, p: 0.5 * jnp.sum((u - jtruth.u) ** 2)),
            piro.Model(tm.residual,
                       lambda u, p: 0.5 * torch.sum((u - ttruth.u) ** 2)))


ANALYSIS = {
    "free": (12, [1.2, 0.1], dict(gtol=1e-10, maxiter=60)),
    "budget": (6, [0.5, 0.5], dict(gtol=1e-8, ctol=1e-9, maxiter=40)),
}
REF_CUT = {"free": dict(maxiter=3), "budget": dict(maxiter=3, maxouter=1)}


def _budget(xp):
    return lambda p: xp.atleast_1d(xp.sum(p) - 1.0)


@functools.lru_cache(maxsize=None)
def jax_analysis(case):
    n, p0, kw = ANALYSIS[case]
    jfit, _ = fit_models(n)
    extra = {"constraint": _budget(jnp)} if case == "budget" else {}
    return jpiro.perform_analysis(jfit, jnp.zeros(n), jnp.asarray(p0),
                                  newton_kw=dict(rtol=1e-13),
                                  **{**kw, **REF_CUT[case], **extra})


def port_analysis(case, cut):
    n, p0, kw = ANALYSIS[case]
    _, tfit = fit_models(n)
    extra = {"constraint": _budget(torch)} if case == "budget" else {}
    return piro.perform_analysis(tfit, torch.zeros(n, dtype=F64), t(p0),
                                 newton_kw=dict(rtol=1e-13),
                                 **{**kw, **(REF_CUT[case] if cut else {}),
                                    **extra})


@pytest.mark.parametrize("case", ["free", "budget"])
def test_analysis_against_jax(case):
    """The optimizer's first iterations (REF_CUT) as the JAX package
    takes them: iterations, the reduced objective and p."""
    res, jres = port_analysis(case, cut=True), jax_analysis(case)
    assert res.iters == jres.iters and res.converged == jres.converged
    np.testing.assert_allclose(res.p.numpy(), np.asarray(jres.p), rtol=0,
                               atol=X_TOL)
    assert abs(res.g - jres.g) <= 1e-10 * max(abs(jres.g), 1e-12)


def test_analysis_recovers_source_strength():
    res = port_analysis("free", cut=False)
    assert res.converged and res.g < 1e-12, (res.g, res.gnorm)
    np.testing.assert_allclose(res.p.numpy(), [0.6, 0.8], atol=1e-4)


def test_constrained_analysis_budget():
    """p0 + p1 = 1 held, the misfit above the unconstrained optimum's, and
    the KKT condition: the reduced gradient parallel to (1, 1)."""
    res = port_analysis("budget", cut=False)
    assert res.converged
    p = res.p.numpy()
    assert abs(p.sum() - 1.0) < 1e-8 and res.g > 1e-8
    _, tfit = fit_models(ANALYSIS["budget"][0])
    r = piro.solve_steady(tfit, torch.zeros(len(res.state.u), dtype=F64),
                          res.p, sensitivities=True, rtol=1e-13)
    dg = r.dgdp.numpy()
    assert abs(dg[0] - dg[1]) < 1e-5 * max(1.0, np.abs(dg).max())
