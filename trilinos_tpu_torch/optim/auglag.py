"""Equality-constrained optimization: augmented Lagrangian
(the ROL Type-E algorithm family).

Counterpart of ``trilinos_tpu/optim/auglag.py``. Reference:
packages/rol/src/step/ROL_AugmentedLagrangianStep.hpp and
ROL_AugmentedLagrangian.hpp — minimize f(x) subject to c(x) = 0 by outer
iterations on

    L_A(x; lam, mu) = f(x) + lam . c(x) + (mu/2) ||c(x)||^2

with LANCELOT-style updates: if the constraint violation fell enough,
tighten the inner tolerance and update the multiplier estimate
lam <- lam + mu c(x); otherwise increase the penalty mu. The inner
unconstrained subproblem is the trust-region Newton-CG (ROL's choice as
well); every derivative of L_A — including the exact Hessian-vector
products through the constraint Jacobian — is autodiff.
"""

from __future__ import annotations

import torch

from .base import OptimizeResult
from .trust_region import trust_region_newton


def augmented_lagrangian(obj, con, x0, *, lam0=None, mu0: float = 10.0,
                         ctol: float = 1e-8, gtol: float = 1e-8,
                         maxouter: int = 30, inner_maxiter: int = 100,
                         mu_factor: float = 10.0, mu_max: float = 1e12,
                         eta_factor: float = 0.5):
    """Minimize ``obj(x)`` subject to ``con(x) = 0`` (``con`` returns a
    (m,) residual). Returns (OptimizeResult, lam) — the result's gnorm
    is the Lagrangian gradient norm and ``converged`` requires BOTH
    stationarity (gtol) and feasibility (ctol)."""
    x = torch.as_tensor(x0)
    m = torch.atleast_1d(con(x)).shape[0]
    lam = (torch.zeros(m, dtype=x.dtype, device=x.device) if lam0 is None
           else torch.as_tensor(lam0, dtype=x.dtype, device=x.device))
    mu = float(mu0)
    eta = 1.0 / mu ** 0.1        # LANCELOT feasibility forcing
    omega = 1.0 / mu             # inner stationarity forcing
    inner_total = 0
    converged = False
    it = -1
    gl = float("inf")

    lag_grad = torch.func.grad(
        lambda xx, ll: obj(xx) + ll @ torch.atleast_1d(con(xx)))

    def al(xx, lam_a, mu_a):
        c = torch.atleast_1d(con(xx))
        return obj(xx) + lam_a @ c + 0.5 * mu_a * torch.vdot(c, c)

    for it in range(maxouter):
        res = trust_region_newton(
            al, x, args=(lam, torch.tensor(mu, dtype=x.dtype,
                                           device=x.device)),
            gtol=max(omega, gtol), maxiter=inner_maxiter)
        x = res.x
        inner_total += res.iters
        cval = torch.atleast_1d(con(x))
        cnorm = float(torch.linalg.norm(cval))
        gl = float(torch.linalg.norm(lag_grad(x, lam + mu * cval)))
        if cnorm <= max(ctol, eta):
            if cnorm <= ctol and gl <= gtol:
                lam = lam + mu * cval
                converged = True
                break
            # good feasibility progress: first-order multiplier update
            lam = lam + mu * cval
            eta *= eta_factor / mu ** 0.9
            omega = max(omega / mu, gtol)
        else:
            # insufficient feasibility: raise the penalty
            mu = min(mu * mu_factor, mu_max)
            eta = 1.0 / mu ** 0.1
            omega = max(1.0 / mu, gtol)

    fval = float(obj(x))
    return OptimizeResult(x=x, fval=fval,
                          gnorm=gl, iters=it + 1,
                          converged=converged,
                          inner_iters=inner_total), lam
