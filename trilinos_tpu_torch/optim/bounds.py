"""Bound-constrained minimization: projected gradient / spectral PG.

Counterpart of ``trilinos_tpu/optim/bounds.py``. Reference anchors:
packages/rol/src/function/ROL_BoundConstraint.hpp (project / pruneActive
protocol), ROL_PrimalDualActiveSetStep.hpp and the projected-search line
searches (ROL_LineSearch.hpp's "Iteration Scaling" along the projection
arc).

Spectral (Barzilai-Borwein) projected gradient with a nonmonotone Armijo
search along the projection arc — the standard SPG method; each candidate
is one project-and-evaluate. Criticality is measured by the
projected-gradient norm ||x - P(x - g)||, ROL's optimality measure for
bounds."""
from __future__ import annotations

import torch

from .base import OptimizeResult, _obj_fns


def projected_gradient(obj, x0, lower, upper, *, gtol: float = 1e-6,
                       maxiter: int = 1000, c1: float = 1e-4,
                       ls_maxsteps: int = 30, history: int = 10
                       ) -> OptimizeResult:
    """Minimize ``obj`` over the box [lower, upper] by spectral
    projected gradient (BB step + nonmonotone Armijo over the last
    `history` values; Birgin-Martinez-Raydan SPG, the method ROL's
    projected-search line search implements for bounds)."""
    val_grad, _, value = _obj_fns(obj)

    def bound(v):
        return torch.broadcast_to(torch.as_tensor(
            v, dtype=x0.dtype, device=x0.device), x0.shape)

    lo, hi = bound(lower), bound(upper)

    def pgnorm(x, g):
        return float(torch.linalg.norm(x - torch.clamp(x - g, lo, hi)))

    x = torch.clamp(x0, lo, hi)
    fx, g = val_grad(x)
    fx = float(fx)
    eps = float(torch.finfo(x.dtype).eps)
    fhist = [fx]
    crit = pgnorm(x, g)
    t_bb = 1.0
    it = inner = 0
    while crit > gtol and it < maxiter:
        t = t_bb
        accepted = False
        fmax = max(fhist)
        for _ in range(ls_maxsteps):
            x_new = torch.clamp(x - t * g, lo, hi)
            f_new = float(value(x_new))
            inner += 1
            dec = float(torch.vdot(g, x_new - x))
            # rounding-noise allowance, as in lbfgs/trust_region
            if f_new <= fmax + c1 * dec + 10.0 * eps * max(abs(fx), 1.0):
                accepted = True
                break
            t *= 0.5
        if not accepted:
            break
        _, g_new = val_grad(x_new)
        s = x_new - x
        yv = g_new - g
        sy = float(torch.vdot(s, yv))
        ss = float(torch.vdot(s, s))
        t_bb = min(max(ss / sy, 1e-10), 1e10) if sy > 0 else 1.0
        x, g, fx = x_new, g_new, f_new
        fhist.append(fx)
        if len(fhist) > history:
            fhist.pop(0)
        crit = pgnorm(x, g)
        it += 1
    return OptimizeResult(x=x, fval=fx, gnorm=crit, iters=it,
                          converged=crit <= gtol, inner_iters=inner)
