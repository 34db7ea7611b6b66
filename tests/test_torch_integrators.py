"""Port parity: the time integrators (``trilinos_tpu_torch/nonlinear/
integrators.py``: theta/backward Euler/trapezoidal, BDF2, SDIRK2, the
adaptive controller, RK4) against the JAX package on every scheme and
problem of ``tests/test_integrators.py``, float64 on the CPU.

The same problems (the SinCos ODE, the method-of-lines heat equation on
Galeri Laplace2D 12² stored as DIA through the port's ``dia_spmv``, scalar
stiff decay, a Gaussian pulse, the logistic equation) go through both
packages. Steps, rejected steps and Newton iterations must be equal and u
within 1e-10 (max |Δ|); the problem's own gates of
``tests/test_integrators.py`` hold for the port. Each JAX march runs once a
module (an ``lru_cache``).
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
from trilinos_tpu_torch import nonlinear as tnl
from trilinos_tpu_torch.galeri import laplace2d
from trilinos_tpu_torch.ops import csr_to_dia, dia_spmv

U_TOL = 1e-10


def j_sincos(t, u):
    return jnp.stack([u[1], -u[0]])


def t_sincos(t, u):
    return torch.stack([u[1], -u[0]])


def sincos_exact(t):
    return np.array([np.sin(t), np.cos(t)])


def same(jres, tres, newton_slack=0):
    assert tres.steps == jres.steps
    assert abs(tres.newton_iters - jres.newton_iters) <= newton_slack
    assert tres.rejected == jres.rejected
    assert tres.t == pytest.approx(jres.t, abs=1e-12)
    assert np.abs(tres.u.numpy() - np.asarray(jres.u)).max() <= U_TOL


STEPPERS = {"backward_euler": (0.1, 0.05), "trapezoidal": (0.1, 0.05),
            "bdf2": (0.1, 0.05), "rk4": (0.2, 0.1), "sdirk2": (0.1, 0.05)}
ORDER_BANDS = {"backward_euler": (0.85, 1.2), "trapezoidal": (1.8, 2.2),
               "bdf2": (1.7, 2.3), "rk4": (3.7, 4.3), "sdirk2": (1.7, 2.3)}


@functools.lru_cache(maxsize=None)
def jax_sincos(name, dt):
    return getattr(jnl, name)(j_sincos, jnp.asarray([0.0, 1.0]), 0.0, 1.0,
                              dt)


def test_sincos_orders():
    """Each stepper's march on SinCos at two steps equals the JAX
    package's, and the observed order lands in its band."""
    for name in STEPPERS:
        _check_sincos_order(name)


def _check_sincos_order(name):
    errs = []
    for dt in STEPPERS[name]:
        res = getattr(tnl, name)(t_sincos, torch.tensor([0.0, 1.0],
                                                        dtype=torch.float64),
                                 0.0, 1.0, dt)
        same(jax_sincos(name, dt), res)
        errs.append(np.linalg.norm(res.u.numpy() - sincos_exact(1.0)))
    dts = STEPPERS[name]
    p = np.log(errs[0] / errs[1]) / np.log(dts[0] / dts[1])
    lo, hi = ORDER_BANDS[name]
    assert lo <= p <= hi, (p, errs)


@functools.lru_cache(maxsize=None)
def heat():
    """(JAX rhs, port rhs, n, npad, lam_min, dt_stable) of
    u' = -(1/h²) A u on Laplace2D 12²."""
    nx = 12
    a = j_laplace2d(nx, nx)
    dev = jF.csr_to_dia(a)
    n, npad = a.shape[0], dev.n_rows_pad
    inv_h2 = float((nx + 1) * (nx + 1))
    mask = np.zeros(npad)
    mask[:n] = 1.0
    mj, mt = jnp.asarray(mask), torch.from_numpy(mask)
    ta = csr_to_dia(laplace2d(nx, nx), device="cpu")
    jrhs = lambda t, u: -inv_h2 * mj * jS.spmv(dev, u, impl="xla")
    trhs = lambda t, u: -inv_h2 * mt * dia_spmv(ta, u)
    h2lam = 4 * 2 * np.sin(np.pi / (2 * (nx + 1))) ** 2
    return jrhs, trhs, n, npad, inv_h2 * h2lam, 2.0 / (inv_h2 * 8.0)


def heat_u0(kind):
    _, _, n, npad, _, _ = heat()
    u0 = np.zeros(npad)
    if kind == "ones":
        u0[:n] = 1.0
    else:
        x = np.arange(1, 13) / 13
        u0[:n] = np.outer(np.sin(np.pi * x), np.sin(np.pi * x)).ravel()
    return u0


@functools.lru_cache(maxsize=None)
def jax_heat(case):
    jrhs, _, _, _, _, dts = heat()
    if case == "be":
        dt = 50 * dts
        return jnl.backward_euler(jrhs, jnp.asarray(heat_u0("ones")), 0.0,
                                  40 * dt, dt)
    return jnl.trapezoidal(jrhs, jnp.asarray(heat_u0("mode")), 0.0, 0.02,
                           1e-3, rtol=1e-12, atol=1e-13)


def test_heat_backward_euler_beyond_explicit_limit():
    """Forty steps at 50x the explicit limit decay u to ~1e-17, where the
    stage tolerance is its floor 10·eps: whether a late stage's Newton
    stops after one more iteration depends on the last bits of a residual
    at rounding level, so the Newton count is held to ±1 (u to 1e-10, the
    decay and the finite values as the JAX test holds them)."""
    _, trhs, n, _, _, dts = heat()
    dt = 50 * dts
    u0 = heat_u0("ones")
    res = tnl.backward_euler(trhs, torch.from_numpy(u0), 0.0, 40 * dt, dt)
    same(jax_heat("be"), res, newton_slack=1)
    u = res.u.numpy()[:n]
    assert np.all(np.isfinite(u))
    assert np.linalg.norm(u) < np.linalg.norm(u0) * 0.9
    assert res.newton_iters >= res.steps


def test_heat_trapezoidal_mode_decay():
    _, trhs, n, _, lam_min, _ = heat()
    u0 = heat_u0("mode")
    res = tnl.trapezoidal(trhs, torch.from_numpy(u0), 0.0, 0.02, 1e-3,
                          rtol=1e-12, atol=1e-13)
    same(jax_heat("trap"), res)
    z = 1e-3 * lam_min
    expected = ((1 - z / 2) / (1 + z / 2)) ** 20
    mode = u0[:n]
    got = (res.u.numpy()[:n] @ mode) / (mode @ mode)
    assert abs(got - expected) < 1e-5 * expected


@functools.lru_cache(maxsize=None)
def jax_stiff_one_step():
    rhs = lambda t, u: -1000.0 * u
    u0 = jnp.asarray([1.0])
    return (jnl.trapezoidal(rhs, u0, 0.0, 0.1, 0.1, rtol=1e-10, atol=1e-12),
            jnl.sdirk2(rhs, u0, 0.0, 0.1, 0.1, rtol=1e-10, atol=1e-12))


def test_sdirk2_damps_where_trapezoidal_rings():
    rhs = lambda t, u: -1000.0 * u
    u0 = torch.tensor([1.0], dtype=torch.float64)
    r_tr = tnl.trapezoidal(rhs, u0, 0.0, 0.1, 0.1, rtol=1e-10, atol=1e-12)
    r_sd = tnl.sdirk2(rhs, u0, 0.0, 0.1, 0.1, rtol=1e-10, atol=1e-12)
    j_tr, j_sd = jax_stiff_one_step()
    same(j_tr, r_tr)
    same(j_sd, r_sd)
    z = 100.0
    assert float(r_tr.u[0]) < -0.9
    assert abs(float(r_sd.u[0])) < 0.06
    g = 1 - 1 / np.sqrt(2)
    rz = (1 - z * (1 - 2 * g)) / (1 + g * z) ** 2
    assert abs(float(r_sd.u[0]) - rz) < 5e-3


def j_pulse(t, u):
    return -u + 50.0 * jnp.exp(-((t - 1.0) / 0.02) ** 2)


def t_pulse(t, u):
    return -u + 50.0 * torch.exp(-((t - 1.0) / 0.02) ** 2)


ADAPTIVE = {
    "sincos2": (j_sincos, t_sincos, [0.0, 1.0],
                dict(t0=0.0, t1=5.0, dt0=0.5, order=2, rtol=1e-5,
                     atol=1e-8)),
    "pulse1": (j_pulse, t_pulse, [1.0],
               dict(t0=0.0, t1=2.0, dt0=0.4, order=1, rtol=1e-4, atol=1e-7,
                    save_every=1)),
    "stiff1": (lambda t, u: -500.0 * u, lambda t, u: -500.0 * u, [1.0],
               dict(t0=0.0, t1=1.0, dt0=0.2, order=1, rtol=1e-3,
                    atol=1e-8)),
}


@functools.lru_cache(maxsize=None)
def jax_adaptive(case):
    jrhs, _, u0, kw = ADAPTIVE[case]
    return jnl.integrate_adaptive(jrhs, jnp.asarray(u0), **kw)


def port_adaptive(case):
    _, trhs, u0, kw = ADAPTIVE[case]
    return tnl.integrate_adaptive(trhs, torch.tensor(u0,
                                                     dtype=torch.float64),
                                  **kw)


def test_adaptive_tolerance_tracking_order2():
    res = port_adaptive("sincos2")
    same(jax_adaptive("sincos2"), res)
    err = np.linalg.norm(res.u.numpy() - sincos_exact(5.0))
    assert abs(res.t - 5.0) < 1e-9
    assert err < 2e-3 and res.steps > 10


def test_adaptive_controller_shrinks_then_grows():
    """The pulse at t = 1: the same accepted times as the JAX package,
    refined into the pulse and grown after, with a rejection there."""
    res = port_adaptive("pulse1")
    jres = jax_adaptive("pulse1")
    same(jres, res)
    np.testing.assert_allclose(res.ts, jres.ts, rtol=0, atol=1e-12)
    dts = np.diff(res.ts)
    assert dts.min() < 0.02 and dts.max() / dts.min() >= 8.0
    assert res.rejected >= 1


def test_adaptive_order1_stiff_decay():
    res = port_adaptive("stiff1")
    same(jax_adaptive("stiff1"), res)
    assert abs(float(res.u[0]) - np.exp(-500.0)) < 1e-3


def test_bad_order_and_theta_rejected():
    u0 = torch.tensor([0.0, 1.0], dtype=torch.float64)
    with pytest.raises(ValueError):
        tnl.integrate_adaptive(t_sincos, u0, 0.0, 1.0, 0.1, order=3)
    with pytest.raises(ValueError):
        tnl.theta_method(t_sincos, u0, 0.0, 1.0, 0.1, theta=0.0)


@functools.lru_cache(maxsize=None)
def jax_plumbing():
    save = jnl.backward_euler(j_sincos, jnp.asarray([0.0, 1.0]), 0.0, 1.0,
                              0.1, save_every=2)
    logistic = jnl.bdf2(lambda t, u: u * (1.0 - u), jnp.asarray([0.1]), 0.0,
                        2.0, 0.02)
    return save, logistic


def test_save_every_trajectory():
    res = tnl.backward_euler(t_sincos, torch.tensor([0.0, 1.0],
                                                    dtype=torch.float64),
                             0.0, 1.0, 0.1, save_every=2)
    jres = jax_plumbing()[0]
    same(jres, res)
    assert len(res.ts) == 1 + 5 and len(res.us) == len(res.ts)
    np.testing.assert_allclose(res.ts, jres.ts, rtol=0, atol=1e-15)
    for uj, ut in zip(jres.us, res.us):
        assert np.abs(ut.numpy() - np.asarray(uj)).max() <= U_TOL
    assert torch.equal(res.us[-1], res.u)


def test_nonlinear_rhs_bdf2():
    """Logistic u' = u(1-u): JFNK inside the stepper, against the closed
    form and the JAX package."""
    res = tnl.bdf2(lambda t, u: u * (1.0 - u),
                   torch.tensor([0.1], dtype=torch.float64), 0.0, 2.0, 0.02)
    same(jax_plumbing()[1], res)
    exact = 0.1 * np.exp(2.0) / (1 - 0.1 + 0.1 * np.exp(2.0))
    assert abs(float(res.u[0]) - exact) < 2e-4
