"""Dogleg trust-region Newton solver.

Counterpart of ``trilinos_tpu/nonlinear/trust_region.py``,
NOX::Solver::TrustRegionBased (reference:
packages/nox/src/NOX_Solver_TrustRegionBased.C — dogleg between the Cauchy
(steepest-descent) point and the (inexact) Newton step on the merit
f = 0.5||F||^2, radius update from the ratio of actual to predicted
reduction).

Both directions are matrix-free: the Newton step via JFNK GMRES, the
gradient grad f = J^T F via one reverse-mode pullback
(base.make_vjp_operator) — no finite differencing anywhere.
"""
from __future__ import annotations

import numpy as np
import torch

from ..parallel.comm import Comm
from ..solvers import gmres
from .base import (NonlinearResult, Residual, default_comm, fnorm2,
                   make_jvp_operator, make_vjp_operator)


def newton_trust_region(f: Residual, x0: torch.Tensor, *,
                        maxiter: int = 50, rtol: float = 1e-8,
                        atol: float = 0.0,
                        radius: float | None = None,
                        max_radius: float = 1e3, min_radius: float = 1e-8,
                        eta_accept: float = 1e-4,
                        shrink_below: float = 0.25, grow_above: float = 0.75,
                        inner_rtol: float = 1e-4,
                        inner_restart: int = 30, inner_maxiter: int = 200,
                        comm: Comm | None = None) -> NonlinearResult:
    """Solve F(x) = 0 by dogleg trust region on 0.5||F||^2.

    Radius control follows NOX_Solver_TrustRegionBased.C: ratio =
    ared/pred; step rejected below ``eta_accept`` (NOX "Minimum
    Improvement Ratio"); radius halved below ``shrink_below``, doubled
    above ``grow_above`` ("Contraction/Expansion Trigger Ratio").
    """
    comm = default_comm(comm)

    def dot(u, v):
        return float(comm.psum(torch.vdot(u, v).real))

    def model_pieces(x, r):
        """Gradient g = J^T r and its curvature gBg = ||J g||^2."""
        grad = make_vjp_operator(f, x)(r)
        jg = make_jvp_operator(f, x)(grad)
        return grad, dot(grad, grad), dot(jg, jg)

    x = x0
    r = f(x)
    fnorm = float(np.sqrt(float(fnorm2(comm, r))))
    target = rtol * fnorm + atol
    delta = radius if radius is not None else max(10.0 * fnorm, 1.0)
    inner_total = 0
    it = 0
    converged = fnorm <= target

    while not converged and it < maxiter and delta > min_radius:
        res = gmres(make_jvp_operator(f, x), -r, restart=inner_restart,
                    maxiter=inner_maxiter, rtol=inner_rtol, comm=comm)
        dn = res.x
        inner_total += int(res.iters)
        dn_norm = float(np.sqrt(dot(dn, dn)))
        grad, g_sq, jg_sq = model_pieces(x, r)
        g_norm = np.sqrt(g_sq)
        # Cauchy point: minimizer of the model along -grad
        t_c = g_sq / max(jg_sq, 1e-300)
        dc_norm = t_c * g_norm

        if dn_norm <= delta:
            d = dn                                  # full Newton inside
        elif dc_norm >= delta:
            d = (-delta / max(g_norm, 1e-300)) * grad
        else:
            # dogleg: d = dc + tau (dn - dc) hitting ||d|| = delta
            dc = -t_c * grad
            pd = dn - dc
            a = dot(pd, pd)
            b = dot(dc, pd)
            c = dc_norm * dc_norm - delta * delta
            tau = (-b + np.sqrt(max(b * b - a * c, 0.0))) / max(a, 1e-300)
            d = dc + tau * pd

        phi0 = 0.5 * fnorm * fnorm
        phi_new = 0.5 * float(fnorm2(comm, f(x + d)))
        # predicted reduction from the Gauss-Newton model
        jd = make_jvp_operator(f, x)(d)
        jd_sq = dot(jd, jd)
        gd = dot(grad, d)
        pred = -(gd + 0.5 * jd_sq)
        ared = phi0 - phi_new
        ratio = ared / pred if pred > 0 else -1.0

        if ratio >= eta_accept:
            x = x + d
            r = f(x)
            fnorm = float(np.sqrt(2.0 * phi_new))
        if ratio < shrink_below:
            delta *= 0.5
        elif ratio > grow_above:
            delta = min(2.0 * delta, max_radius)
        it += 1
        converged = fnorm <= target

    return NonlinearResult(x=x, iters=it, fnorm=fnorm,
                           converged=bool(converged),
                           inner_iters=inner_total)
