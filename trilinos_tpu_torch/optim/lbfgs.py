"""Limited-memory BFGS with a strong-Wolfe line search (ROL analogue).

Counterpart of ``trilinos_tpu/optim/lbfgs.py``. Reference anchors:
packages/rol/src/step/ROL_LineSearchStep.hpp (descent step = secant
direction + line search), ROL_lBFGS.hpp (the two-loop recursion over the
(s, y) history), ROL_Secant.hpp (curvature-pair acceptance),
ROL_BackTracking.hpp.

The history is a list of at most ``memory`` (s, y, 1/s.y) pairs, oldest
first; the two-loop recursion runs over the stored pairs, newest first and
then oldest first, in the order of the JAX package's masked ``fori_loop``
over its fixed (m, n) slots (whose empty slots add exact zeros)."""
from __future__ import annotations

import torch

from .base import OptimizeResult, _obj_fns


def _direction(g, pairs, gamma):
    """-H_k g via the two-loop recursion over ``pairs`` (oldest first)."""
    q = g
    alpha = [None] * len(pairs)
    for i in reversed(range(len(pairs))):
        s, y, rho = pairs[i]
        alpha[i] = rho * torch.vdot(s, q)
        q = q - alpha[i] * y
    r = gamma * q
    for i, (s, y, rho) in enumerate(pairs):
        b = rho * torch.vdot(y, r)
        r = r + (alpha[i] - b) * s
    return -r


def _wolfe_search(val_grad, x, d, fx, slope, *, c1, c2, noise,
                  maxsteps):
    """Strong-Wolfe line search (Nocedal-Wright Alg. 3.5/3.6
    bracket + zoom; the guarantee that s.y > 0 so every secant pair is
    storable — Armijo alone lets the curvature pair go negative in a
    curved valley and freezes the L-BFGS history).

    Returns (t, f_t, g_t, evals) or (None, ...) on failure. ``noise``
    is the rounding-level allowance on the sufficient-decrease test."""
    def phi(t):
        f_t, g_t = val_grad(x + t * d)
        return float(f_t), g_t, float(torch.vdot(g_t, d))

    evals = 0

    def zoom(lo, f_lo, hi, budget):
        nonlocal evals
        f_best = f_lo
        for _ in range(budget):
            t = 0.5 * (lo + hi)
            f_t, g_t, dphi_t = phi(t)
            evals += 1
            if (f_t > fx + c1 * t * slope + noise) or f_t >= f_best:
                hi = t
            else:
                if abs(dphi_t) <= -c2 * slope:
                    return t, f_t, g_t
                if dphi_t * (hi - lo) >= 0:
                    hi = lo
                lo, f_best = t, f_t
        f_t, g_t, _ = phi(lo)
        evals += 1
        return lo, f_t, g_t

    t_prev, f_prev = 0.0, fx
    t = 1.0
    for i in range(maxsteps):
        f_t, g_t, dphi_t = phi(t)
        evals += 1
        if (f_t > fx + c1 * t * slope + noise) or (i > 0
                                                   and f_t >= f_prev):
            t, f_t, g_t = zoom(t_prev, f_prev, t, maxsteps - i)
            return t, f_t, g_t, evals
        if abs(dphi_t) <= -c2 * slope:
            return t, f_t, g_t, evals
        if dphi_t >= 0:
            t, f_t, g_t = zoom(t, f_t, t_prev, maxsteps - i)
            return t, f_t, g_t, evals
        t_prev, f_prev = t, f_t
        t *= 2.0
    return (t, f_t, g_t, evals) if f_t <= fx + noise else (None, fx,
                                                           None, evals)


def lbfgs(obj, x0, *, memory: int = 10, gtol: float = 1e-6,
          maxiter: int = 500, c1: float = 1e-4, c2: float = 0.9,
          ls_maxsteps: int = 25) -> OptimizeResult:
    """Minimize smooth ``obj(x) -> scalar`` by L-BFGS (ROL
    "Line Search" step with the "Limited-Memory BFGS" secant and the
    strong-Wolfe "Cubic Interpolation"-class search ROL pairs it with).

    The Wolfe curvature condition |g_new.d| <= c2 |g.d| guarantees
    s.y > 0, so every accepted step yields a valid secant pair; pairs
    are additionally gated on s.y > 1e-10 ||s|| ||y|| (ROL_Secant's
    updateStorage acceptance test) and the initial Hessian scaling is
    the Barzilai-Borwein gamma = s.y / y.y."""
    val_grad, _, _ = _obj_fns(obj)
    pairs: list[tuple] = []
    gamma = 1.0

    x = x0
    fx, g = val_grad(x)
    fx = float(fx)
    gnorm = float(torch.linalg.norm(g))
    eps = float(torch.finfo(x.dtype).eps)
    it = inner = 0
    while gnorm > gtol and it < maxiter:
        d = _direction(g, pairs, torch.tensor(gamma, dtype=x.dtype,
                                              device=x.device))
        slope = float(torch.vdot(g, d))
        if slope >= 0:  # stale curvature produced an ascent direction
            d, slope = -g, -gnorm * gnorm
        # sufficient decrease cannot be resolved below the rounding
        # noise of f — allow it (else f32 runs backtrack forever near
        # the optimum; same safeguard as the trust-region rho)
        noise = 10.0 * eps * max(abs(fx), 1.0)
        t, f_new, g_new, evals = _wolfe_search(
            val_grad, x, d, fx, slope, c1=c1, c2=c2, noise=noise,
            maxsteps=ls_maxsteps)
        inner += evals
        if t is None:
            break
        x_new = x + t * d
        s = x_new - x
        yv = g_new - g
        sy = float(torch.vdot(s, yv))
        if sy > 1e-10 * float(torch.linalg.norm(s)
                              * torch.linalg.norm(yv)):
            pairs.append((s, yv, torch.tensor(1.0 / sy, dtype=x.dtype,
                                              device=x.device)))
            if len(pairs) > memory:
                pairs.pop(0)
            gamma = sy / float(torch.vdot(yv, yv))
        x, g = x_new, g_new
        fx = f_new
        gnorm = float(torch.linalg.norm(g))
        it += 1
    return OptimizeResult(x=x, fval=fx, gnorm=gnorm, iters=it,
                          converged=gnorm <= gtol, inner_iters=inner)
