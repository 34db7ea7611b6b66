"""Trust-region Newton with Steihaug-Toint truncated CG (ROL analogue).

Counterpart of ``trilinos_tpu/optim/trust_region.py``. Reference anchors:
packages/rol/src/step/ROL_TrustRegionStep.hpp (the radius-update loop
with gamma/eta constants), ROL_TrustRegion.hpp, and the subproblem solver
ROL_TruncatedCG.hpp (CG on the quadratic model, exiting at negative
curvature or the radius boundary).

The truncated CG is a host loop with the JAX package's stopping tests
(negative curvature, the radius crossed, the interior tolerance, the
iteration cap); each iteration reads the curvature, the step's squared
norm and the new residual's. Hessian actions are exact forward-over-reverse
autodiff; nothing is assembled.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import OptimizeResult, _obj_fns

# ROL_TrustRegionStep defaults (ROL_TrustRegion.hpp ctor): step
# acceptance threshold eta0, radius-shrink/grow tests eta1/eta2,
# shrink/grow factors gamma1/gamma2.
_ETA0, _ETA1, _ETA2 = 1e-4, 0.25, 0.75
_GAMMA1, _GAMMA2 = 0.25, 2.0


def _boundary_tau(z, p, delta):
    """Positive root of ||z + tau p||^2 = delta^2."""
    pp = torch.vdot(p, p)
    zp = torch.vdot(z, p)
    zz = torch.vdot(z, z)
    disc = torch.sqrt(torch.clamp(zp * zp + pp * (delta * delta - zz),
                                  min=0.0))
    return (disc - zp) / torch.clamp(pp, min=1e-300)


def _tcg(hvp, x, g, delta, tol, maxiter, args):
    """Steihaug-Toint truncated CG for the quadratic model at x.

    Returns (d, pred_reduction, hit_boundary, iters): the step, the
    model decrease m(0)-m(d) >= 0, whether the radius or negative
    curvature terminated the solve, and CG iterations used."""
    z = torch.zeros_like(g)
    r, p = g, -g
    rr = torch.vdot(g, g)
    it, done, hit = 0, False, False
    while not done and it < maxiter:
        hp = hvp(x, p, *args)
        kappa = torch.vdot(p, hp)
        neg = float(kappa) <= 0
        alpha = rr / (kappa if not neg else torch.ones_like(kappa))
        z_new = z + alpha * p
        crossed = float(torch.vdot(z_new, z_new)) >= float(delta * delta)
        r_new = r + alpha * hp
        rr_new = torch.vdot(r_new, r_new)
        interior_done = float(torch.sqrt(rr_new)) <= float(tol)
        beta = rr_new / torch.clamp(rr, min=1e-300)
        p_new = -r_new + beta * p
        # negative curvature or the radius crossed: walk to the boundary
        z = z + _boundary_tau(z, p, delta) * p if neg or crossed else z_new
        done = neg or crossed or interior_done
        hit = hit or neg or crossed
        r, p, rr = r_new, p_new, rr_new
        it += 1
    pred = -(torch.vdot(g, z) + 0.5 * torch.vdot(z, hvp(x, z, *args)))
    return z, pred, hit, it


def trust_region_newton(obj, x0, *, args: tuple = (),
                        gtol: float = 1e-6,
                        maxiter: int = 100, delta0: float = 1.0,
                        delta_max: float = 1e8,
                        cg_maxiter: int = 250) -> OptimizeResult:
    """Minimize a smooth ``obj(x, *args) -> scalar`` by trust-region
    Newton-CG (ROL "Trust Region" step with the "Truncated CG"
    subproblem solver). ``args`` are extra objective arguments (the
    augmented Lagrangian's multipliers and penalty).

    Inexact-Newton forcing: the CG tolerance is
    min(0.5, sqrt(gnorm)) * gnorm, giving superlinear convergence
    without over-solving far from the optimum."""
    val_grad, hvp, value = _obj_fns(obj)

    def scalar(v):
        return torch.tensor(v, dtype=x0.dtype, device=x0.device)

    x = x0
    fx, g = val_grad(x, *args)
    fx = float(fx)
    gnorm = float(torch.linalg.norm(g))
    delta = float(delta0)
    eps = float(torch.finfo(x.dtype).eps)
    it = inner = 0
    while gnorm > gtol and it < maxiter:
        tol = min(0.5, np.sqrt(gnorm)) * gnorm
        d, pred, hit, cg_it = _tcg(hvp, x, g, scalar(delta), scalar(tol),
                                   cg_maxiter, args)
        inner += cg_it
        pred = float(pred)
        f_new = float(value(x + d, *args))
        # noise-regularized ratio (Conn-Gould-Toint §17 practice): once
        # the model decrease sinks below the floating-point noise of f,
        # the raw ratio is rounding garbage and delta would collapse
        # spuriously — bias both sides by the noise level instead.
        noise = 10.0 * eps * max(abs(fx), 1.0)
        rho = (fx - f_new + noise) / (max(pred, 1e-300) + noise)
        dnorm = float(torch.linalg.norm(d))
        if rho < _ETA1:
            delta = _GAMMA1 * dnorm
        elif rho > _ETA2 and hit:
            delta = min(_GAMMA2 * delta, delta_max)
        if rho > _ETA0 and f_new <= fx + noise:
            x = x + d
            fx2, g = val_grad(x, *args)
            fx = float(fx2)
            gnorm = float(torch.linalg.norm(g))
        it += 1
        if delta < 1e-14:
            break
    return OptimizeResult(x=x, fval=fx, gnorm=gnorm, iters=it,
                          converged=gnorm <= gtol, inner_iters=inner)
