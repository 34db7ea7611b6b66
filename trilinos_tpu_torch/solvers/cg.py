"""Conjugate-gradient family.

Counterpart of ``trilinos_tpu/solvers/cg.py``:

* ``cg``: preconditioned CG (the analogue of Belos::PseudoBlockCGIter),
  per iteration one operator apply, one preconditioner apply and two
  reductions, the r·z and r·r dots sharing one ``psum``;
* ``cg_single_reduce``: Chronopoulos–Gear CG with one fused reduction per
  iteration (Belos::CGSingleRedIter);
* ``cg_fused``: the single-reduce recurrence on a matrix-free stencil with
  one fused kernel launch per iteration (``ops/cg_fused.py``).

Multivector RHS (``cg``, ``cg_single_reduce``): reductions are columnwise
and converged columns are frozen by zeroing their step sizes. Each loop
condition reads one residual scalar on the host once per iteration.
"""
from __future__ import annotations

import torch

from ..ops.blas import local_dot
from ..ops.cg_fused import cg_fused_iteration, require_applicable
from ..ops.matvec import spmv
from ..parallel.comm import Comm, SerialComm
from .base import (Operator, SolveResult, bcast_cols, certified_solve,
                   identity_prec, rhs_norm_scale, safe_divide)

# solvers/status.py and ops/compensated.py exist (gmres takes stop, history,
# condest and compensated); what is left is their wiring into cg
_LATER = ("is not wired into cg yet: only the cg wiring is left (ROADMAP.md "
          "queue 1 item 3, cg options)")


def cg(op: Operator, b: torch.Tensor, x0: torch.Tensor | None = None, *,
       prec: Operator | None = None, rtol: float = 1e-8, atol: float = 0.0,
       maxiter: int = 1000, comm: Comm | None = None,
       condest_window: int = 0, stop=None, history: bool = False,
       compensated: bool = False) -> SolveResult:
    """Preconditioned CG certified by an explicit residual (see
    ``certified_solve``). ``condest_window``, ``stop``, ``history`` and
    ``compensated`` keep the JAX signature and raise until ported."""
    for name, val in (("condest_window", condest_window), ("stop", stop),
                      ("history", history), ("compensated", compensated)):
        if val:
            raise NotImplementedError(f"cg({name}=...) {_LATER}")
    comm = comm or SerialComm()
    M = prec or identity_prec
    x = torch.zeros_like(b) if x0 is None else x0

    def dot_pair(u1, v1, u2, v2):
        d = comm.psum(torch.stack([local_dot(u1, v1), local_dot(u2, v2)]))
        return d[0], d[1]

    def dot_one(u, v):
        return comm.psum(local_dot(u, v))

    bb = dot_one(b, b)
    tol = rhs_norm_scale(torch.sqrt(bb), rtol, atol)

    def solve_from(x, tol2, k):
        r = b - op(x)
        z = M(r)
        p = z
        rz, rr = dot_pair(r, z, r, r)
        while k < maxiter and bool((rr > tol2).any()):
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
            rr = torch.where(active, rr_new, rr)
            k += 1
        return x, k

    x, k, resnorm, conv = certified_solve(solve_from, op, b, x, tol, maxiter,
                                          comm)
    return SolveResult(x=x, iters=k, resnorm=resnorm, converged=conv)


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
