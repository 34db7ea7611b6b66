"""Conjugate-gradient family.

Counterpart of ``trilinos_tpu/solvers/cg.py``:

* ``cg``: preconditioned CG (the analogue of Belos::PseudoBlockCGIter),
  per iteration one operator apply, one preconditioner apply and two
  reductions, the r·z and r·r dots sharing one ``psum``; with the
  reference's options: the free Lanczos condition estimate
  (``condest_window``), a status test (``stop``), the residual trace
  (``history``) and double-single dots (``compensated``);
* ``cg_single_reduce``: Chronopoulos–Gear CG with one fused reduction per
  iteration (Belos::CGSingleRedIter);
* ``cg_pipeline``: pipelined CG (Ghysels–Vanroose) with residual
  replacement every ``replace_every`` iterations (BASELINE config 4);
* ``stochastic_cg``: CG that also draws a sample y ~ N(0, A⁻¹)
  (Belos::PseudoBlockStochasticCGIter);
* ``cg_fused``: the single-reduce recurrence on a matrix-free stencil with
  one fused kernel launch per iteration (``ops/cg_fused.py``).

Multivector RHS (all but ``cg_fused``): reductions are columnwise and
converged columns are frozen by zeroing their step sizes. Each loop
condition reads one residual scalar on the host once per iteration; the
recorded Lanczos coefficients and the history stay on the device.
"""
from __future__ import annotations

import math

import torch

from ..ops.blas import local_dot
from ..ops.cg_fused import cg_fused_iteration, require_applicable
from ..ops.compensated import _renorm, comp_dot_global, comp_local_dot
from ..ops.matvec import spmv
from ..parallel.comm import Comm, SerialComm
from .base import (Operator, SolveResult, bcast_cols, certified_solve,
                   certify_residual, identity_prec, rhs_norm_scale,
                   safe_divide)
from .status import SolverState


def _tridiag_condest(alphas: torch.Tensor, betas: torch.Tensor,
                     m: int) -> torch.Tensor:
    """κ estimate from CG coefficients via the CG↔Lanczos connection
    (AztecOO's AZ_cg_condnum): the Lanczos tridiagonal of M·A has
    diag_j = 1/α_j + β_{j−1}/α_{j−1} and offdiag_j = √β_j / α_j; its extreme
    eigenvalues (the Ritz values of the first min(iters, window) steps)
    give λmax/λmin, a lower bound on κ(M·A).

    alphas, betas: (..., cw) recorded coefficients, one row a column; m:
    number of valid steps. Unused slots hold the first Rayleigh quotient
    1/α_0, which is inside the Ritz interval and never moves the extremes.
    """
    cw = alphas.shape[-1]
    j = torch.arange(cw, device=alphas.device)
    valid = (j < m) & (alphas != 0)
    one = torch.ones_like(alphas)
    zero = torch.zeros_like(alphas)
    a_safe = torch.where(valid, alphas, one)
    b_rec = torch.where(valid, betas, zero)
    a_prev = torch.cat([one[..., :1], a_safe[..., :-1]], dim=-1)
    b_prev = torch.cat([zero[..., :1], b_rec[..., :-1]], dim=-1)
    fill = torch.where(valid[..., :1], 1.0 / a_safe[..., :1], one[..., :1])
    diag = torch.where(valid, 1.0 / a_safe + b_prev / a_prev, fill)
    valid_next = torch.cat([valid[..., 1:], torch.zeros_like(valid[..., :1])],
                           dim=-1)
    off = torch.where(valid & valid_next,
                      torch.sqrt(torch.clamp(b_rec, min=0.0)) / a_safe, zero)
    t = (torch.diag_embed(diag) + torch.diag_embed(off[..., :-1], 1)
         + torch.diag_embed(off[..., :-1], -1))
    w = torch.linalg.eigvalsh(t)
    lo = torch.clamp(w[..., 0], min=torch.finfo(w.dtype).tiny)
    return w[..., -1] / lo


def _dots(comm: Comm, compensated: bool):
    """(dot_pair, dot_one): two columnwise dots in one psum, and one dot;
    plain or double-single (Dot2) sums with the same reduction count."""
    if compensated:
        def dot_pair(u1, v1, u2, v2):
            s = comm.psum(torch.stack([comp_local_dot(u1, v1),
                                       comp_local_dot(u2, v2)]))
            h1, l1 = _renorm(s[0, 0], s[0, 1])
            h2, l2 = _renorm(s[1, 0], s[1, 1])
            return h1 + l1, h2 + l2

        def dot_one(u, v):
            return comp_dot_global(comm, u, v)
    else:
        def dot_pair(u1, v1, u2, v2):
            d = comm.psum(torch.stack([local_dot(u1, v1),
                                       local_dot(u2, v2)]))
            return d[0], d[1]

        def dot_one(u, v):
            return comm.psum(local_dot(u, v))
    return dot_pair, dot_one


def cg(op: Operator, b: torch.Tensor, x0: torch.Tensor | None = None, *,
       prec: Operator | None = None, rtol: float = 1e-8, atol: float = 0.0,
       maxiter: int = 1000, comm: Comm | None = None,
       condest_window: int = 0, stop=None, history: bool = False,
       compensated: bool = False) -> SolveResult:
    """Preconditioned CG certified by an explicit residual (see
    ``certified_solve``).

    ``condest_window`` > 0 records the first ``condest_window`` (α, β)
    pairs on the device and returns a per-column estimate of κ(M·A) in
    ``SolveResult.condest`` (no extra applies or reductions). A retry pass
    starts a fresh Lanczos process: the β recorded at the seam is zeroed,
    so T is the direct sum of genuine Lanczos blocks and stays a lower
    bound. ``stop``: a status test (``solvers.status``) on all columns at
    once, evaluated every iteration; passing (for every column) stops the
    solve, and no retry pass follows. ``history=True`` records the
    recurrence residual norms in a (maxiter+1,) or (maxiter+1, k) tensor,
    NaN past the end; entry k0 of each pass is its explicit residual.
    ``compensated=True`` takes every dot as a double-single (Dot2) sum."""
    comm = comm or SerialComm()
    M = prec or identity_prec
    x = torch.zeros_like(b) if x0 is None else x0
    cw = int(min(condest_window, maxiter))
    use_aux = bool(cw) or history
    dot_pair, dot_one = _dots(comm, compensated)

    bb = dot_one(b, b)
    tol = rhs_norm_scale(torch.sqrt(bb), rtol, atol)

    def stop_passed(k, rr):
        return bool(torch.all(stop(SolverState(
            iters=k, resnorm=torch.sqrt(rr), rhs_norm=torch.sqrt(bb)))))

    def solve_from(x, tol2, k, aux=None):
        k0 = k
        r = b - op(x)
        z = M(r)
        p = z
        rz, rr = dot_pair(r, z, r, r)
        if history:
            # index k0: the explicit residual entering this pass
            aux["hist"][k0] = torch.sqrt(rr)
        while k < maxiter and bool((rr > tol2).any()) and not (
                stop is not None and stop_passed(k, rr)):
            active = rr > tol2
            ap = op(p)
            pap = dot_one(p, ap)
            alpha = torch.where(active, safe_divide(rz, pap),
                                torch.zeros_like(rz))
            x = x + bcast_cols(alpha, p)
            r = r - bcast_cols(alpha, ap)
            z = M(r)
            rz_new, rr_new = dot_pair(r, z, r, r)
            beta = torch.where(active, safe_divide(rz_new, rz),
                               torch.zeros_like(rz))
            p = z + bcast_cols(beta, p)
            rz = torch.where(active, rz_new, rz)
            if cw:
                alphas, betas = aux["lanczos"]
                if k < cw:
                    alphas[k] = alpha
                    betas[k] = beta
                if k == k0 and k0 > 0 and k0 - 1 < cw:
                    # a retry pass is a fresh Lanczos process: sever the
                    # coupling to the previous one at the seam
                    betas[k0 - 1] = 0
            if history:
                aux["hist"][k + 1] = torch.where(active, torch.sqrt(rr_new),
                                                 aux["hist"][k + 1])
            rr = torch.where(active, rr_new, rr)
            k += 1
        return (x, k, aux) if use_aux else (x, k)

    halt = stop_passed if stop is not None else None
    if not use_aux:
        x, k, resnorm, conv = certified_solve(solve_from, op, b, x, tol,
                                              maxiter, comm, halt=halt)
        return SolveResult(x=x, iters=k, resnorm=resnorm, converged=conv)

    rdt = bb.dtype
    cshape = () if b.ndim == 1 else (b.shape[1],)
    aux0 = {}
    if cw:
        aux0["lanczos"] = tuple(torch.zeros((cw,) + cshape, dtype=rdt,
                                            device=b.device)
                                for _ in range(2))
    if history:
        aux0["hist"] = torch.full((maxiter + 1,) + cshape, math.nan,
                                  dtype=rdt, device=b.device)
    x, k, resnorm, conv, aux = certified_solve(
        solve_from, op, b, x, tol, maxiter, comm, aux0=aux0, halt=halt)
    ce = None
    if cw:
        alphas, betas = aux["lanczos"]
        ce = _tridiag_condest(alphas.movedim(0, -1), betas.movedim(0, -1),
                              min(k, cw))
    return SolveResult(x=x, iters=k, resnorm=resnorm, converged=conv,
                       condest=ce, history=aux.get("hist"))


def stochastic_cg(op: Operator, b: torch.Tensor,
                  x0: torch.Tensor | None = None, *,
                  prec: Operator | None = None, rtol: float = 1e-8,
                  atol: float = 0.0, maxiter: int = 1000,
                  comm: Comm | None = None,
                  generator: torch.Generator | None = None
                  ) -> tuple[SolveResult, torch.Tensor]:
    """Stochastic CG (Parker–Fox): solves A x = b and draws y ~ N(0, A⁻¹)
    by accumulating y += (ξ_k / √(pᵀAp)) p, with ξ_k iid N(0, 1), one per
    column and iteration, drawn from ``generator`` (None: a generator on
    b's device seeded 0). Returns (SolveResult, y). x and the iteration
    count do not depend on ξ. The sample's law is exact when CG runs to
    full accuracy in exact arithmetic; partial convergence gives an
    approximate sample from the dominant subspace."""
    comm = comm or SerialComm()
    M = prec or identity_prec
    x = torch.zeros_like(b) if x0 is None else x0
    if generator is None:
        generator = torch.Generator(device=b.device)
        generator.manual_seed(0)

    r = b - op(x)
    z = M(r)
    p = z
    y = torch.zeros_like(b)
    d0 = comm.psum(torch.stack([local_dot(r, z), local_dot(r, r),
                                local_dot(b, b)]))
    rz, rr, bb = d0[0], d0[1], d0[2]
    tol = rhs_norm_scale(torch.sqrt(bb), rtol, atol)
    tol2 = tol * tol
    ncols = () if b.ndim == 1 else (b.shape[1],)
    k = 0
    while k < maxiter and bool((rr > tol2).any()):
        active = rr > tol2
        zero = torch.zeros_like(rz)
        ap = op(p)
        pap = comm.psum(local_dot(p, ap))
        alpha = torch.where(active, safe_divide(rz, pap), zero)
        xi = torch.randn(ncols, generator=generator, dtype=b.dtype,
                         device=b.device)
        s_coef = torch.where(active, xi * torch.rsqrt(
            torch.where(pap > 0, pap, torch.ones_like(pap))), zero)
        x = x + bcast_cols(alpha, p)
        y = y + bcast_cols(s_coef, p)
        r = r - bcast_cols(alpha, ap)
        z = M(r)
        d = comm.psum(torch.stack([local_dot(r, z), local_dot(r, r)]))
        rz_new, rr_new = d[0], d[1]
        beta = torch.where(active, safe_divide(rz_new, rz), zero)
        p = z + bcast_cols(beta, p)
        rz = torch.where(active, rz_new, rz)
        rr = torch.where(active, rr_new, rr)
        k += 1
    resnorm, conv = certify_residual(op, b, x, tol, comm)
    return SolveResult(x=x, iters=k, resnorm=resnorm, converged=conv), y


def cg_single_reduce(op: Operator, b: torch.Tensor,
                     x0: torch.Tensor | None = None, *,
                     prec: Operator | None = None, rtol: float = 1e-8,
                     atol: float = 0.0, maxiter: int = 1000,
                     comm: Comm | None = None) -> SolveResult:
    """Chronopoulos–Gear CG, one fused reduction per iteration. With
    z = M r, w = A z: δ = <z, w>, rz = <r, z>, rr = <r, r> in one psum;
    β = rz / rz_prev (0 on the first step); α = rz / (δ − β·rz/α_prev)."""
    comm = comm or SerialComm()
    M = prec or identity_prec
    x = torch.zeros_like(b) if x0 is None else x0
    bb = comm.psum(local_dot(b, b))
    tol = rhs_norm_scale(torch.sqrt(bb), rtol, atol)

    def dots(r, z, w):
        return comm.psum(torch.stack([local_dot(r, z), local_dot(z, w),
                                      local_dot(r, r)]))

    def solve_from(x, tol2, k):
        r = b - op(x)
        z = M(r)
        w = op(z)
        rz, delta, rr = dots(r, z, w)
        alpha = safe_divide(rz, delta)
        p, q = z, w
        while k < maxiter and bool((rr > tol2).any()):
            active = rr > tol2
            a = torch.where(active, alpha, torch.zeros_like(alpha))
            x = x + bcast_cols(a, p)
            r = r - bcast_cols(a, q)
            z = M(r)
            w = op(z)
            rz_new, delta, rr_new = dots(r, z, w)
            beta = torch.where(active, safe_divide(rz_new, rz),
                               torch.zeros_like(rz))
            alpha_new = safe_divide(
                rz_new, delta - beta * safe_divide(rz_new, alpha))
            alpha = torch.where(active, alpha_new, alpha)
            p = z + bcast_cols(beta, p)
            q = w + bcast_cols(beta, q)
            rz = torch.where(active, rz_new, rz)
            rr = torch.where(active, rr_new, rr)
            k += 1
        return x, k

    x, k, resnorm, conv = certified_solve(solve_from, op, b, x, tol, maxiter,
                                          comm)
    return SolveResult(x=x, iters=k, resnorm=resnorm, converged=conv)


def cg_pipeline(op: Operator, b: torch.Tensor,
                x0: torch.Tensor | None = None, *,
                prec: Operator | None = None, rtol: float = 1e-8,
                atol: float = 0.0, maxiter: int = 1000,
                comm: Comm | None = None,
                replace_every: int = 50) -> SolveResult:
    """Pipelined CG (Ghysels–Vanroose) with periodic residual replacement.

    Each iteration issues its one fused reduction before the next
    preconditioner and operator applies, and the host reads the result
    only at the next loop test, so the applies queue behind the reduction
    without waiting for it (Belos_Tpetra_CgPipeline's early idot). The
    extra recurrence vectors drift in finite precision, so every
    ``replace_every`` iterations the state is rebuilt from the true
    residual r = b − A x and the current search direction (the
    reference's schedule, which keeps iteration counts equal); the
    segment restarts α from ⟨r, u⟩ / ⟨p, Ap⟩, the exact CG step for the
    kept direction."""
    comm = comm or SerialComm()
    M = prec or identity_prec
    x = torch.zeros_like(b) if x0 is None else x0
    bb = comm.psum(local_dot(b, b))
    tol = rhs_norm_scale(torch.sqrt(bb), rtol, atol)

    def dots(*pairs):
        return comm.psum(torch.stack([local_dot(u, v) for u, v in pairs]))

    def refresh(x, p):
        """The pipelined state rebuilt from scratch (replacement step)."""
        r = b - op(x)
        u = M(r)
        w = op(u)
        s_v = op(p)
        q = M(s_v)
        z = op(q)
        gamma, _, rr, pap = dots((r, u), (w, u), (r, r), (p, s_v))
        return r, u, w, s_v, q, z, gamma, rr, safe_divide(gamma, pap)

    def solve_from(x, tol2, k):
        p = M(b - op(x))
        rr = torch.full_like(tol2, math.inf)
        while k < maxiter and bool((rr > tol2).any()):
            r, u, w, s_v, q, z, gamma, rr, alpha = refresh(x, p)
            k0 = k
            while (k < maxiter and k - k0 < replace_every
                   and bool((rr > tol2).any())):
                active = rr > tol2
                a = torch.where(active, alpha, torch.zeros_like(alpha))
                x = x + bcast_cols(a, p)
                r = r - bcast_cols(a, s_v)
                u = u - bcast_cols(a, q)
                w = w - bcast_cols(a, z)
                # the step's reduction first, then the next apply chain
                gamma_new, delta, rr_new = dots((r, u), (w, u), (r, r))
                m_next = M(w)
                n_next = op(m_next)
                beta = torch.where(active, safe_divide(gamma_new, gamma),
                                   torch.zeros_like(gamma))
                alpha_new = safe_divide(
                    gamma_new, delta - beta * safe_divide(gamma_new, alpha))
                alpha = torch.where(active, alpha_new, alpha)
                p = u + bcast_cols(beta, p)
                s_v = w + bcast_cols(beta, s_v)
                q = m_next + bcast_cols(beta, q)
                z = n_next + bcast_cols(beta, z)
                gamma = torch.where(active, gamma_new, gamma)
                rr = torch.where(active, rr_new, rr)
                k += 1
        return x, k

    x, k, resnorm, conv = certified_solve(solve_from, op, b, x, tol, maxiter,
                                          comm)
    return SolveResult(x=x, iters=k, resnorm=resnorm, converged=conv)


def cg_fused(op_stencil, b: torch.Tensor, x0: torch.Tensor | None = None, *,
             rtol: float = 1e-8, atol: float = 0.0,
             maxiter: int = 1000) -> SolveResult:
    """Unpreconditioned single-reduce CG on a ``StencilOp`` without pad rows
    (``ops.cg_fused.cg_fused_applicable``), single device and RHS, with one
    ``cg_fused_iteration`` per iteration, certified by an explicit
    residual."""
    require_applicable(op_stencil)
    comm = SerialComm()
    x = torch.zeros_like(b) if x0 is None else x0
    tol = rhs_norm_scale(torch.sqrt(local_dot(b, b)), rtol, atol)

    def solve_from(x, tol2, k):
        r = b - spmv(op_stencil, x)
        w = spmv(op_stencil, r)
        rz = local_dot(r, r)
        scal = torch.stack([rz, local_dot(r, w), torch.zeros_like(rz),
                            torch.ones_like(rz)]).reshape(1, 4)
        p = torch.zeros_like(r)  # β = 0 on the first pass: p_0 = r
        q = torch.zeros_like(r)
        while k < maxiter and bool(scal[0, 0] > tol2):
            x, r, w, p, q, scal = cg_fused_iteration(op_stencil, x, r, w, p,
                                                     q, scal)
            k += 1
        return x, k

    x, k, resnorm, conv = certified_solve(
        solve_from, lambda v: spmv(op_stencil, v), b, x, tol, maxiter, comm)
    return SolveResult(x=x, iters=k, resnorm=resnorm, converged=conv)
