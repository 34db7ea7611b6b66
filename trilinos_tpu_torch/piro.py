"""Top-level analysis drivers (the Piro analogue).

Counterpart of ``trilinos_tpu/piro.py``. Reference: packages/piro/src —
Piro::NOXSolver (steady solves exposing responses + sensitivities),
Piro::TempusSolver (transient), and the Piro::PerformAnalysis entry that
hands a response-gradient model to an optimizer (ROL). The reference's
ModelEvaluator protocol (residual f, responses g, df/dp, dg/dp) collapses
here to two callables — ``torch.func`` supplies every derivative block the
C++ stack asks applications to code by hand, through the kernel wrappers'
derivative rules where the residual applies a stored or stencil matrix.

Sensitivities are adjoint: dg/dp = g_p - lambda^T f_p with
J^T lambda = g_u, solved matrix-free by GMRES on the vjp operator
(Piro_NOXSolver_Def.hpp's adjoint branch). Parameters are tensors of the
state's dtype on its device; numpy parameters are converted.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from .nonlinear import newton_krylov
from .nonlinear.integrators import integrate_adaptive
from .solvers import gmres


@dataclasses.dataclass(frozen=True)
class Model:
    """f(u, p) = 0 with optional scalar response g(u, p)
    (the ModelEvaluator reduced to its differentiable core)."""

    residual: Callable  # (u, p) -> r
    response: Callable | None = None  # (u, p) -> scalar


@dataclasses.dataclass
class SteadyResult:
    u: torch.Tensor
    converged: bool
    iters: int
    g: torch.Tensor | None = None
    dgdp: torch.Tensor | None = None
    inner_iters: int = 0      # GMRES iterations of the Newton solve
    adjoint_iters: int = 0    # GMRES iterations of the adjoint solve


def _param(p, like: torch.Tensor):
    """p on ``like``'s device; host parameters take ``like``'s dtype."""
    if not isinstance(p, torch.Tensor):
        p = torch.as_tensor(np.asarray(p), dtype=like.dtype)
    return p.to(like.device)


def solve_steady(model: Model, u0: torch.Tensor, p, *,
                 sensitivities: bool = False, adjoint_rtol: float = 1e-8,
                 **newton_kw) -> SteadyResult:
    """Steady solve + response + adjoint parameter sensitivities."""
    p = _param(p, u0)
    res = newton_krylov(lambda u, pp: model.residual(u, pp), u0,
                        args=(p,), **newton_kw)
    out = SteadyResult(u=res.x, converged=res.converged, iters=res.iters,
                       inner_iters=res.inner_iters)
    if model.response is None:
        return out
    out.g = model.response(res.x, p)
    if not sensitivities:
        return out
    u = res.x
    g_u = torch.func.grad(model.response, argnums=0)(u, p)
    g_p = torch.func.grad(model.response, argnums=1)(u, p)
    # adjoint: J(u)^T lam = g_u, matrix-free via vjp
    _, pull_u = torch.func.vjp(lambda uu: model.residual(uu, p), u)
    lam_res = gmres(lambda v: pull_u(v)[0], g_u, rtol=adjoint_rtol,
                    maxiter=newton_kw.get("inner_maxiter", 400))
    _, pull_p = torch.func.vjp(lambda pp: model.residual(u, pp), p)
    out.dgdp = g_p - pull_p(lam_res.x)[0]
    out.adjoint_iters = lam_res.iters
    return out


def solve_transient(model: Model, u0: torch.Tensor, p,
                    t0: float, t1: float, dt0: float, *,
                    rtol: float = 1e-4, atol: float = 1e-7, **kw):
    """Transient solve of du/dt = -f(u, p) (residual convention: f is the
    steady residual, so the ODE right-hand side is its negation) with the
    adaptive integrator; returns the IntegratorResult and, if the model
    has a response, g(u(t1), p)."""
    p = _param(p, u0)
    rhs = lambda t, u: -model.residual(u, p)
    result = integrate_adaptive(rhs, u0, t0, t1, dt0,
                                rtol=rtol, atol=atol, **kw)
    g = model.response(result.u, p) if model.response else None
    return result, g


@dataclasses.dataclass
class CoupledResult:
    states: list
    iters: int
    converged: bool
    delta: float  # final max relative state change


def solve_coupled(models: list, u0: list, couplers: list, *,
                  tol: float = 1e-8, maxiter: int = 50,
                  mode: str = "seidel",
                  newton_kw: dict | None = None) -> CoupledResult:
    """Black-box multiphysics coupling (the Pike analogue:
    pike/src/Pike_Solver_BlockGaussSeidel.hpp / BlockJacobi): each model
    solves with the others' states frozen, ``couplers[i](states)``
    producing its parameter from them; fixed-point iterate until the max
    relative state change drops below tol.

    mode="seidel" uses fresh states within a sweep (faster transfer of
    information); "jacobi" uses the previous sweep's states (all model
    solves independent — the mode to parallelize across models).
    """
    if mode not in ("seidel", "jacobi"):
        raise ValueError(mode)
    nk = dict(rtol=1e-10, atol=1e-12)
    nk.update(newton_kw or {})
    states = [torch.as_tensor(u) for u in u0]
    delta = np.inf
    it = 0
    for it in range(1, maxiter + 1):
        src = states if mode == "seidel" else [s for s in states]
        prev = [s.cpu().numpy() for s in states]
        for i, model in enumerate(models):
            p_i = couplers[i](src)
            r = solve_steady(model, states[i], p_i, **nk)
            states[i] = r.u
            if mode == "seidel":
                src = states
        delta = max(
            float(np.linalg.norm(states[i].cpu().numpy() - prev[i])
                  / max(np.linalg.norm(prev[i]), 1e-30))
            for i in range(len(models)))
        if delta <= tol:
            return CoupledResult(states, it, True, delta)
    return CoupledResult(states, it, False, delta)


@dataclasses.dataclass
class AnalysisResult:
    p: torch.Tensor
    g: float
    gnorm: float
    iters: int
    converged: bool
    state: SteadyResult


def perform_analysis(model: Model, u0: torch.Tensor, p0, *,
                     gtol: float = 1e-6, maxiter: int = 50,
                     memory: int = 10, ls_maxsteps: int = 20,
                     newton_kw: dict | None = None,
                     constraint=None, ctol: float = 1e-8,
                     mu0: float = 10.0,
                     maxouter: int = 15) -> AnalysisResult:
    """min_p g(u(p), p) s.t. f(u, p) = 0 (Piro::PerformAnalysis driving
    the reduced-space problem): L-BFGS two-loop on the host with Armijo
    backtracking — every objective evaluation is a steady PDE solve
    (warm-started from the previous state) and every gradient is one
    adjoint solve, the reduced-gradient loop the reference runs through
    ROL (rol/src/algorithm/ROL_Algorithm.hpp).

    ``constraint``: optional design-space equality constraint h(p) = 0
    (a torch function of p); handled by the same LANCELOT-style augmented
    Lagrangian as optim.augmented_lagrangian (ROL Type-E), with the
    reduced objective/gradient inside. Converged then means BOTH the
    reduced AL gradient <= gtol AND ||h(p)|| <= ctol."""
    if model.response is None:
        raise ValueError("perform_analysis needs a model response")
    nk = dict(rtol=1e-10, atol=1e-12)
    nk.update(newton_kw or {})
    state = {"u": u0}

    def eval_reduced(p):
        r = solve_steady(model, state["u"], p, sensitivities=True, **nk)
        state["u"] = r.u  # warm start the next solve
        return float(r.g), r.dgdp.cpu().numpy()

    if constraint is not None:
        return _analysis_auglag(model, state, eval_reduced, p0,
                                constraint, gtol=gtol, ctol=ctol,
                                mu0=mu0, maxouter=maxouter,
                                maxiter=maxiter, memory=memory,
                                ls_maxsteps=ls_maxsteps, nk=nk)
    p, fval, grad, it, converged = _lbfgs_loop(
        eval_reduced, _host(p0), gtol, maxiter, memory, ls_maxsteps)
    final = solve_steady(model, state["u"], p, sensitivities=True, **nk)
    return AnalysisResult(p=_param(p, u0), g=fval,
                          gnorm=float(np.linalg.norm(grad)), iters=it,
                          converged=converged, state=final)


def _host(p) -> np.ndarray:
    if isinstance(p, torch.Tensor):
        p = p.cpu().numpy()
    return np.asarray(p, dtype=np.float64)


def _lbfgs_loop(eval_pg, p, gtol, maxiter, memory, ls_maxsteps):
    """The reduced-space L-BFGS body shared by the plain and the
    augmented-Lagrangian analysis paths (both call it)."""
    fval, grad = eval_pg(p)
    s_hist, y_hist = [], []
    converged = False
    it = 0
    for it in range(1, maxiter + 1):
        gnorm = float(np.linalg.norm(grad))
        if gnorm <= gtol:
            converged = True
            break
        q = grad.copy()
        alphas = []
        for s, y in reversed(list(zip(s_hist, y_hist))):
            a = float(s @ q) / float(s @ y)
            alphas.append(a)
            q = q - a * y
        if y_hist:
            q = q * (float(s_hist[-1] @ y_hist[-1])
                     / float(y_hist[-1] @ y_hist[-1]))
        for (s, y), a in zip(zip(s_hist, y_hist), reversed(alphas)):
            q = q + (a - float(y @ q) / float(s @ y)) * s
        d = -q
        slope = float(grad @ d)
        if slope >= 0:
            d, slope = -grad, -gnorm ** 2
        step = 1.0
        for i in range(max(ls_maxsteps, 1)):
            f_new, g_new = eval_pg(p + step * d)
            if f_new <= fval + 1e-4 * step * slope:
                break
            if i < max(ls_maxsteps, 1) - 1:
                # only halve when another evaluation follows, so on
                # exhaustion (f_new, g_new) belong to p + step*d
                step *= 0.5
        s_vec = step * d
        y_vec = g_new - grad
        if float(s_vec @ y_vec) > 1e-10 * np.linalg.norm(s_vec) \
                * np.linalg.norm(y_vec):
            s_hist.append(s_vec)
            y_hist.append(y_vec)
            if len(s_hist) > memory:
                s_hist.pop(0)
                y_hist.pop(0)
        p, fval, grad = p + step * d, f_new, g_new
    return p, fval, grad, it, converged


def _analysis_auglag(model, state, eval_reduced, p0, constraint, *,
                     gtol, ctol, mu0, maxouter, maxiter, memory,
                     ls_maxsteps, nk):
    """Constrained analysis: LANCELOT-style augmented Lagrangian over
    the reduced objective (mirrors optim/auglag.py with PDE solves as
    the inner evaluations)."""
    like = state["u"]

    def h_of(pp):
        return torch.atleast_1d(constraint(pp))

    p = _host(p0)
    m = int(h_of(_param(p, like)).shape[0])
    lam = np.zeros(m)
    mu = float(mu0)
    eta = 1.0 / mu ** 0.1
    omega = 1.0 / mu
    total_inner = 0
    converged = False
    fval = np.inf
    grad = np.full_like(p, np.inf)
    for _ in range(maxouter):
        lam_c, mu_c = lam.copy(), mu

        def eval_al(pp):
            g, dg = eval_reduced(pp)
            hv, pull = torch.func.vjp(h_of, _param(pp, like))
            hnp = hv.cpu().numpy()
            w = lam_c + mu_c * hnp
            g_al = g + float(lam_c @ hnp) + 0.5 * mu_c * float(hnp @ hnp)
            dg_al = dg + pull(_param(w, like))[0].cpu().numpy()
            return g_al, dg_al

        p, fval, grad, it_in, _ = _lbfgs_loop(
            eval_al, p, max(omega, gtol), maxiter, memory, ls_maxsteps)
        total_inner += it_in
        hnp = h_of(_param(p, like)).cpu().numpy()
        cnorm = float(np.linalg.norm(hnp))
        gnorm = float(np.linalg.norm(grad))
        if cnorm <= max(ctol, eta):
            if cnorm <= ctol and gnorm <= gtol:
                lam = lam + mu * hnp
                converged = True
                break
            lam = lam + mu * hnp
            eta *= 0.5 / mu ** 0.9
            omega = max(omega / mu, gtol)
        else:
            mu = min(mu * 10.0, 1e12)
            eta = 1.0 / mu ** 0.1
            omega = max(1.0 / mu, gtol)
    final = solve_steady(model, state["u"], p, sensitivities=True, **nk)
    return AnalysisResult(p=_param(p, like), g=float(final.g),
                          gnorm=float(np.linalg.norm(grad)),
                          iters=total_inner, converged=converged,
                          state=final)
