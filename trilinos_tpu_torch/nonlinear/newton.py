"""Jacobian-free Newton-Krylov with forcing terms and line search.

Counterpart of ``trilinos_tpu/nonlinear/newton.py``, NOX's line-search
based Newton solver:

  * outer loop             — NOX_Solver_LineSearchBased.C (iterate():
    direction -> line search -> status test);
  * Newton direction       — NOX_Direction_Newton.C (inexact Newton with
    "Forcing Term Method" Constant / Type 1 / Type 2,
    NOX_Direction_Newton.C:88-99: eta bounds 1e-4..0.9, alpha 1.5,
    gamma 0.9 — the Eisenstat-Walker schedules);
  * line search            — NOX_LineSearch_Backtrack.C (simple decrease,
    halving) and NOX_LineSearch_Polynomial.C (Armijo sufficient decrease
    with quadratic interpolation and a minimum-step safeguard).

The Jacobian action is exact forward-mode AD (base.make_jvp_operator); the
correction solve is the port's GMRES, so a preconditioner built for the
linearized operator (AMG, ILU, Schwarz...) plugs in through ``prec_factory``.
The host reads the same scalars where the JAX package reads them, so the
decisions (forcing terms, line-search steps, stops) follow the same values.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..parallel.comm import Comm
from ..solvers import gmres
from ..solvers.base import Operator
from .base import (NonlinearResult, Residual, default_comm, fnorm2,
                   make_jvp_operator)


def _forcing_eta(method, eta_prev, fnorm, fnorm_prev, lin_resnorm,
                 eta_min=1e-4, eta_max=0.9, alpha=1.5, gamma=0.9):
    """Next inexact-Newton forcing term (NOX_Direction_Newton.C:88-124).

    Type 1: eta = |''fnorm - lin_resnorm''| / fnorm_prev  (Eisenstat-
    Walker choice 1 — how well the last linear model predicted F).
    Type 2: eta = gamma * (fnorm/fnorm_prev)^alpha.
    Both carry the standard safeguard keeping eta from collapsing when
    the previous eta was still large."""
    if method == "type1":
        eta = abs(fnorm - lin_resnorm) / max(fnorm_prev, 1e-300)
        safe = eta_prev ** ((1 + np.sqrt(5)) / 2)
    elif method == "type2":
        eta = gamma * (fnorm / max(fnorm_prev, 1e-300)) ** alpha
        safe = gamma * eta_prev ** alpha
    else:
        raise ValueError(f"unknown forcing method {method!r}")
    if safe > 0.1:
        eta = max(eta, safe)
    return float(np.clip(eta, eta_min, eta_max))


def newton_krylov(f: Residual, x0: torch.Tensor, *,
                  args: tuple = (),
                  jac: Callable[[torch.Tensor], Operator] | None = None,
                  prec_factory: Callable[[torch.Tensor], Operator]
                  | None = None,
                  maxiter: int = 30, rtol: float = 1e-8, atol: float = 0.0,
                  forcing: str | float = "type2",
                  linesearch: str = "polynomial",
                  ls_alpha: float = 1e-4, ls_maxsteps: int = 12,
                  ls_lambda_min: float = 1e-6,
                  inner_restart: int = 30, inner_maxiter: int = 200,
                  comm: Comm | None = None) -> NonlinearResult:
    """Solve F(x) = 0 by inexact (Jacobian-free) Newton-Krylov.

    Stops when ||F(x)|| <= rtol*||F(x0)|| + atol (the NOX NormF relative
    status test, NOX_StatusTest_NormF.H). ``jac`` optionally supplies the
    linearized operator at x (e.g. a refrozen stencil); by default the
    exact AD action is used. ``prec_factory(x)`` builds a right
    preconditioner for each correction solve.

    forcing: "type1" | "type2" (Eisenstat-Walker) or a constant float
    (NOX "Constant" forcing). linesearch: "full" | "backtrack" (simple
    decrease, halving) | "polynomial" (Armijo + quadratic interpolation).

    ``args``: extra tensors passed as ``f(x, *args)`` (per-step data:
    previous state, time, parameter).
    """
    comm = default_comm(comm)
    fb = (lambda y: f(y, *args)) if args else f

    def fn_sq(y):
        return float(fnorm2(comm, fb(y)))

    x = x0
    r = fb(x)
    fnorm = float(np.sqrt(float(fnorm2(comm, r))))
    f0 = fnorm
    target = rtol * f0 + atol
    eta = forcing if isinstance(forcing, (int, float)) else 1e-2
    fnorm_prev = fnorm
    lin_resnorm = 0.0
    inner_total = 0
    it = 0
    converged = fnorm <= target

    while not converged and it < maxiter:
        if isinstance(forcing, str) and it > 0:
            eta = _forcing_eta(forcing, eta, fnorm, fnorm_prev,
                               lin_resnorm)
        # over-solve guard: no point solving the model far past the
        # nonlinear target (Eisenstat-Walker practical safeguard)
        eta_k = max(float(eta), 0.5 * target / max(fnorm, 1e-300))
        eta_k = min(eta_k, 0.9)
        op = jac(x) if jac is not None else make_jvp_operator(fb, x)
        prec = prec_factory(x) if prec_factory is not None else None
        res = gmres(op, -r, prec=prec, restart=inner_restart,
                    maxiter=inner_maxiter, rtol=eta_k, comm=comm)
        d = res.x
        inner_total += int(res.iters)
        lin_resnorm = float(torch.max(torch.atleast_1d(res.resnorm)))
        fnorm_prev = fnorm

        phi0 = 0.5 * fnorm * fnorm
        dphi0 = -fnorm * fnorm + fnorm * lin_resnorm  # <= 0 up to slack
        if dphi0 >= 0:
            dphi0 = -fnorm * fnorm
        lam = 1.0
        if linesearch == "full":
            x = x + d
            fnorm = float(np.sqrt(fn_sq(x)))
        else:
            for _ in range(ls_maxsteps):
                phi = 0.5 * fn_sq(x + lam * d)
                if linesearch == "backtrack":
                    ok = phi < phi0                     # simple decrease
                else:
                    ok = phi <= phi0 + ls_alpha * lam * dphi0  # Armijo
                if ok or lam <= ls_lambda_min:
                    break
                if linesearch == "polynomial":
                    # quadratic model through phi0, dphi0, phi(lam);
                    # NOX Polynomial's [0.1, 0.5]*lam bracket safeguard
                    denom = 2.0 * (phi - phi0 - dphi0 * lam)
                    lam_new = (-dphi0 * lam * lam / denom
                               if denom > 0 else 0.5 * lam)
                    lam = float(np.clip(lam_new, 0.1 * lam, 0.5 * lam))
                else:
                    lam *= 0.5
                lam = max(lam, ls_lambda_min)
            x = x + lam * d
            fnorm = float(np.sqrt(2.0 * phi))
        r = fb(x)
        it += 1
        converged = fnorm <= target

    return NonlinearResult(x=x, iters=it, fnorm=fnorm,
                           converged=bool(converged),
                           inner_iters=inner_total)
