"""Time integrators (Tempus analogue) for u' = f(t, u).

Counterpart of ``trilinos_tpu/nonlinear/integrators.py``. Reference
anchors: packages/tempus/src/Tempus_StepperBackwardEuler_impl.hpp
(implicit residual u_dot - f = 0 solved by the wrapped NOX solver),
Tempus_StepperTrapezoidal_impl.hpp, Tempus_StepperBDF2_impl.hpp (BDF2
with a one-step startup stepper), Tempus_StepperDIRK_impl.hpp (SDIRK
tableaus; '2 Stage 2nd order' is the L-stable gamma = 1 - 1/sqrt(2)
pair), Tempus_StepperExplicitRK_impl.hpp, and the variable-step
controller Tempus_TimeStepControl_impl.hpp +
Tempus_TimeStepControlStrategyBasicVS.hpp.

Every implicit stage of every stepper here is the same residual shape
    R(u) = u - base - w * f(t, u)
with (base, w, t) as data — backward Euler (w=dt), theta (w=theta*dt),
BDF2 (w=2dt/3), each SDIRK stage (w=gamma*dt), and every trial step of the
adaptive controller — handed to the JFNK Newton driver with (base, w, t)
as ``args`` (t and w as 0-d tensors of u's dtype). The stage Jacobian
action comes from autodiff, where Tempus re-assembles W = alpha*M + beta*J
per step. The explicit RK4 path is a host loop over steps.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..parallel.comm import Comm
from .base import default_comm
from .newton import newton_krylov

Rhs = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]   # f(t, u)

#: L-stable 2-stage SDIRK gamma (Tempus 'SDIRK 2 Stage 2nd order',
#: Tempus_StepperDIRK_impl.hpp): A=[[g,0],[1-g,g]], b=[1-g,g], c=[g,1];
#: stiffly accurate, so u_{n+1} is the second stage value.
_SDIRK2_GAMMA = 1.0 - 1.0 / np.sqrt(2.0)


@dataclasses.dataclass
class IntegratorResult:
    t: float                 # final time reached
    u: torch.Tensor          # state at t
    steps: int               # accepted steps
    newton_iters: int        # total Newton iterations (implicit only)
    rejected: int = 0        # rejected trial steps (adaptive only)
    ts: np.ndarray | None = None            # optional trajectory times
    us: list[torch.Tensor] | None = None    # optional trajectory states


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def _stage_fns(f):
    """Helpers shared by all implicit steppers: the one-stage implicit
    residual and the forward-Euler predictor."""
    def stage_resid(u, base, w, t):
        return u - base - w * f(t, u)

    def predictor(un, fn, h):
        return un + h * fn

    return stage_resid, predictor


def _solve_stage(stage_resid, guess, base, w, t, *, tol, newton_kw,
                 comm):
    """One implicit stage R(u) = u - base - w f(t,u) = 0 by JFNK.

    Newton stops on a solution-scaled absolute test ||R|| <= tol, not
    relative to the predictor's residual: a good predictor makes
    ||R(guess)|| tiny and a tolerance relative to it is unattainable in
    f32 (the Tempus/SUNDIALS (atol + rtol*|u|)-weighted convention)."""
    res = newton_krylov(stage_resid, guess,
                        args=(base, w, t), comm=comm,
                        rtol=0.0, atol=tol, **newton_kw)
    if not res.converged:
        raise RuntimeError(
            f"implicit stage at t={float(t):g} failed to converge "
            f"(fnorm={res.fnorm:.3e}, dt-scale w={float(w):g})")
    return res.x, res.iters


def _default_tols(u0, rtol, atol):
    """Dtype-aware Newton tolerances: eps^0.75 relative to ||u_n||
    (~7e-6 in f32, ~1.6e-12 in f64) unless the caller says."""
    eps = float(torch.finfo(u0.dtype).eps)
    if rtol is None:
        rtol = eps ** 0.75
    if atol is None:
        atol = 10.0 * eps
    return rtol, atol


def _norm32(u: torch.Tensor) -> float:
    """||u|| in float32, the scale of the stage tolerance."""
    return float(torch.linalg.norm(u.to(torch.float32)))


def _march(plan, u0, t0, t1, dt, *, save_every, newton_kw, rtol, atol,
           comm, stage_resid):
    """Shared fixed-step host loop: ``plan(un, hist, t, t_new)`` yields
    one or more (base, w, t, guess) stages; the last stage value is
    u_{n+1} (all steppers here are stiffly accurate in that sense)."""
    nsteps = int(round((t1 - t0) / dt))
    u, t = u0, t0
    hist = {"prev": None}
    total_newton = 0
    ts, us = [t0], [u0]
    for k in range(nsteps):
        t_new = t0 + (k + 1) * dt
        tol_k = atol + rtol * _norm32(u)
        hist["prev_step"] = u
        for base, w, t_s, guess in plan(u, hist, t, t_new):
            u_s, it = _solve_stage(stage_resid, guess, base, w, t_s,
                                   tol=tol_k, newton_kw=newton_kw,
                                   comm=comm)
            total_newton += it
            hist["stage"] = u_s
        hist["prev"] = hist.pop("prev_step")
        u, t = hist.pop("stage"), t_new
        if save_every and (k + 1) % save_every == 0:
            ts.append(t)
            us.append(u)
    saved = (np.asarray(ts), us) if save_every else (None, None)
    return IntegratorResult(t=t, u=u, steps=nsteps,
                            newton_iters=total_newton,
                            ts=saved[0], us=saved[1])


def theta_method(f: Rhs, u0: torch.Tensor, t0: float, t1: float, dt: float,
                 *, theta: float = 1.0, save_every: int = 0,
                 rtol: float | None = None, atol: float | None = None,
                 newton_maxiter: int = 20,
                 comm: Comm | None = None) -> IntegratorResult:
    """One-stage theta stepper: theta=1 is backward Euler
    (Tempus_StepperBackwardEuler), theta=0.5 trapezoidal/Crank-Nicolson
    (Tempus_StepperTrapezoidal). Stage residual
        R(u) = u - [u_n + dt(1-theta) f_n] - dt*theta f(t_{n+1}, u)."""
    if not 0.0 < theta <= 1.0:
        raise ValueError("theta in (0, 1]; use rk4 for explicit")
    comm = default_comm(comm)
    rtol, atol = _default_tols(u0, rtol, atol)
    stage_resid, predictor = _stage_fns(f)
    h = dt

    def plan(un, hist, t, t_new):
        fn = f(_scalar(t, un), un)
        base = un + h * (1.0 - theta) * fn if theta < 1.0 else un
        guess = predictor(un, fn, _scalar(h, un))
        yield (base, _scalar(h * theta, un), _scalar(t_new, un), guess)

    return _march(plan, u0, t0, t1, dt, save_every=save_every,
                  newton_kw=dict(forcing="type2",
                                 maxiter=newton_maxiter),
                  rtol=rtol, atol=atol, comm=comm,
                  stage_resid=stage_resid)


def backward_euler(f: Rhs, u0: torch.Tensor, t0: float, t1: float,
                   dt: float, **kw) -> IntegratorResult:
    return theta_method(f, u0, t0, t1, dt, theta=1.0, **kw)


def trapezoidal(f: Rhs, u0: torch.Tensor, t0: float, t1: float,
                dt: float, **kw) -> IntegratorResult:
    return theta_method(f, u0, t0, t1, dt, theta=0.5, **kw)


def bdf2(f: Rhs, u0: torch.Tensor, t0: float, t1: float, dt: float, *,
         save_every: int = 0, rtol: float | None = None,
         atol: float | None = None, newton_maxiter: int = 20,
         comm: Comm | None = None) -> IntegratorResult:
    """Fixed-step BDF2 with a backward-Euler startup step
    (Tempus_StepperBDF2_impl.hpp uses a pluggable one-step start stepper;
    BE is its default). Residual for n >= 1:
        R(u) = u - (4 u_n - u_{n-1})/3 - (2/3) dt f(t_{n+1}, u)
    — the same stage shape as BE."""
    comm = default_comm(comm)
    rtol, atol = _default_tols(u0, rtol, atol)
    stage_resid, predictor = _stage_fns(f)
    h = dt

    def plan(un, hist, t, t_new):
        fn = f(_scalar(t, un), un)
        guess = predictor(un, fn, _scalar(h, un))
        t_a = _scalar(t_new, un)
        if hist["prev"] is None:   # startup: backward Euler
            yield un, _scalar(h, un), t_a, guess
        else:
            base = (4.0 * un - hist["prev"]) / 3.0
            yield base, _scalar(2.0 / 3.0 * h, un), t_a, guess

    return _march(plan, u0, t0, t1, dt, save_every=save_every,
                  newton_kw=dict(forcing="type2",
                                 maxiter=newton_maxiter),
                  rtol=rtol, atol=atol, comm=comm,
                  stage_resid=stage_resid)


def sdirk2(f: Rhs, u0: torch.Tensor, t0: float, t1: float, dt: float, *,
           save_every: int = 0, rtol: float | None = None,
           atol: float | None = None, newton_maxiter: int = 20,
           comm: Comm | None = None) -> IntegratorResult:
    """L-stable 2-stage SDIRK, order 2 (Tempus 'SDIRK 2 Stage 2nd
    order', gamma = 1 - 1/sqrt(2)). Unlike trapezoidal (A-stable only)
    the stiff modes are damped, not flipped in sign.

    Stage 1: U1 = u_n + dt*g f(t_n + g dt, U1)
    Stage 2: U2 = u_n + dt(1-g) k1 + dt*g f(t_n + dt, U2),
             k1 = (U1 - u_n)/(dt g);  u_{n+1} = U2 (stiffly accurate).
    Both stages are the universal residual with w = g*dt."""
    comm = default_comm(comm)
    rtol, atol = _default_tols(u0, rtol, atol)
    stage_resid, predictor = _stage_fns(f)
    g = _SDIRK2_GAMMA
    h = dt

    def plan(un, hist, t, t_new):
        fn = f(_scalar(t, un), un)
        w = _scalar(g * h, un)
        guess1 = predictor(un, fn, _scalar(g * h, un))
        yield un, w, _scalar(t + g * h, un), guess1
        u1 = hist["stage"]
        k1 = (u1 - un) / (g * h)
        base2 = un + h * (1.0 - g) * k1
        guess2 = predictor(un, k1, _scalar(h, un))
        yield base2, w, _scalar(t_new, un), guess2

    return _march(plan, u0, t0, t1, dt, save_every=save_every,
                  newton_kw=dict(forcing="type2",
                                 maxiter=newton_maxiter),
                  rtol=rtol, atol=atol, comm=comm,
                  stage_resid=stage_resid)


def integrate_adaptive(f: Rhs, u0: torch.Tensor, t0: float, t1: float,
                       dt0: float, *, order: int = 2,
                       rtol: float = 1e-4, atol: float = 1e-8,
                       safety: float = 0.9, dt_min: float | None = None,
                       dt_max: float | None = None,
                       max_steps: int = 100000, save_every: int = 0,
                       newton_rtol: float | None = None,
                       newton_atol: float | None = None,
                       newton_maxiter: int = 20,
                       comm: Comm | None = None) -> IntegratorResult:
    """Variable-step implicit integration with local-error control
    (Tempus_TimeStepControl + TimeStepControlStrategyBasicVS analogue,
    with the standard predictor-corrector error estimate in place of
    Tempus's dt-halving heuristics).

    order=1: backward Euler; local error estimated against the
    forward-Euler predictor, est = ||u - u_pred||/2 (the Milne device).
    order=2: trapezoidal; estimated against the variable-step
    Adams-Bashforth-2 predictor with the exact Milne factor
    h/(3(h + h_prev)) (constant-step limit 1/6). First step falls back
    to the order-1 estimate.

    Error norm: WRMS, err = rms(e_i / (atol + rtol |u_i|)); a step is
    accepted when err <= 1 and the next dt is
    dt * clip(safety * err^(-1/(order+1)), 0.2, 5) (the SUNDIALS/Tempus
    controller convention)."""
    if order not in (1, 2):
        raise ValueError("order must be 1 (BE) or 2 (trapezoidal)")
    comm = default_comm(comm)
    newton_rtol, newton_atol = _default_tols(u0, newton_rtol,
                                             newton_atol)
    stage_resid, predictor = _stage_fns(f)
    theta = 1.0 if order == 1 else 0.5
    dt_min = dt_min if dt_min is not None else 1e-12 * (t1 - t0)
    dt_max = dt_max if dt_max is not None else (t1 - t0)

    def wrms(e, u):
        scale = atol + rtol * torch.abs(u)
        return float(torch.sqrt(torch.mean((e / scale) ** 2)))

    u, t = u0, t0
    dt = min(dt0, dt_max)
    fn = f(_scalar(t0, u0), u0)
    f_prev, dt_prev = None, None   # AB2 history (f_{n-1}, h_{n-1})
    just_failed = False  # cap growth to 1 right after a rejection
    total_newton = accepted = rejected = 0
    ts, us = [t0], [u0]
    while t < t1 - 1e-12 * max(abs(t1), 1.0):
        if accepted + rejected >= max_steps:
            raise RuntimeError(
                f"adaptive integrator exceeded max_steps={max_steps} "
                f"at t={t:g} (dt={dt:g})")
        dt = min(dt, t1 - t)
        h = _scalar(dt, u)
        base = u if theta == 1.0 else u + 0.5 * h * fn
        tol_k = newton_atol + newton_rtol * _norm32(u)
        u_new, it = _solve_stage(
            stage_resid, predictor(u, fn, h), base,
            _scalar(theta * dt, u), _scalar(t + dt, u),
            tol=tol_k, newton_kw=dict(forcing="type2",
                                      maxiter=newton_maxiter),
            comm=comm)
        total_newton += it
        if order == 2 and f_prev is not None:
            r = dt / dt_prev
            u_pred = u + h * ((1.0 + 0.5 * r) * fn - 0.5 * r * f_prev)
            factor = dt / (3.0 * (dt + dt_prev))
        else:
            u_pred = predictor(u, fn, h)
            factor = 0.5
        err = wrms(factor * (u_new - u_pred), u_new)
        grow = safety * err ** (-1.0 / (order + 1)) if err > 0 else 5.0
        if err <= 1.0:
            accepted += 1
            f_prev, dt_prev = fn, dt
            u, t = u_new, t + dt
            fn = f(_scalar(t, u), u)
            if save_every and accepted % save_every == 0:
                ts.append(t)
                us.append(u)
            # no growth immediately after a failure (SUNDIALS eta cap):
            # prevents the accept-at-5x -> reject ping-pong
            dt = float(np.clip(
                dt * np.clip(grow, 0.2, 1.0 if just_failed else 5.0),
                dt_min, dt_max))
            just_failed = False
        else:
            rejected += 1
            just_failed = True
            dt = float(np.clip(dt * np.clip(grow, 0.1, 0.9),
                               dt_min, dt_max))
            if dt <= dt_min * (1 + 1e-12):
                raise RuntimeError(
                    f"adaptive step underflow at t={t:g} (err={err:g})")
    saved = (np.asarray(ts), us) if save_every else (None, None)
    return IntegratorResult(t=t, u=u, steps=accepted,
                            newton_iters=total_newton,
                            rejected=rejected, ts=saved[0], us=saved[1])


def rk4(f: Rhs, u0: torch.Tensor, t0: float, t1: float,
        dt: float) -> IntegratorResult:
    """Classic explicit RK4 as a host loop over steps
    (Tempus_StepperExplicitRK with the 'RK4' tableau); t reaches f as a
    0-d tensor of u's dtype."""
    nsteps = int(round((t1 - t0) / dt))
    u = u0
    for k in range(nsteps):
        t = t0 + _scalar(float(k), u) * dt
        k1 = f(t, u)
        k2 = f(t + dt / 2, u + dt / 2 * k1)
        k3 = f(t + dt / 2, u + dt / 2 * k2)
        k4 = f(t + dt, u + dt * k3)
        u = u + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
    return IntegratorResult(t=t0 + nsteps * dt, u=u, steps=nsteps,
                            newton_iters=0)
