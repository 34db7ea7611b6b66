"""Shared nonlinear-solver infrastructure.

Counterpart of ``trilinos_tpu/nonlinear/base.py``, the NOX abstract layer
(reference: packages/nox/src/NOX_Solver_Generic.H, NOX_Abstract_Group.C —
iterate/status protocol over an abstract vector).

The nonlinear outer loop runs on the host, as NOX's solvers are host loops
over Group operations; residual evaluations, Jacobian-vector products, the
Krylov correction solve and the line-search merits are torch calls on the
residual's device. The residual is any callable ``F(x) -> r`` built from
torch operations and the port's kernel wrappers, whose derivative rules
(``ops/autodiff.py``) give ``torch.func`` the Jacobian actions: exact
forward-mode JVPs instead of NOX's finite-difference MatrixFree operator
(NOX_Epetra_MatrixFree.H), and reverse-mode VJPs for the transpose.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..parallel.comm import Comm, SerialComm

Residual = Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass
class NonlinearResult:
    """What a nonlinear solve returns."""

    x: torch.Tensor
    iters: int         # outer (Newton/Anderson) iterations
    fnorm: float       # final ||F(x)||_2
    converged: bool
    inner_iters: int   # total inner Krylov iterations (0 if none)


def fnorm2(comm: Comm, r: torch.Tensor) -> torch.Tensor:
    """Global squared two-norm of a residual vector."""
    return comm.psum(torch.vdot(r, r).real)


def make_jvp_operator(f: Residual, x: torch.Tensor):
    """Exact Jacobian-action operator v -> F'(x) v via forward-mode AD.

    Each call linearizes at the captured x again (the primal is recomputed
    with the tangent). This is the JFNK operator handed to GMRES
    (reference contrast: NOX_Epetra_MatrixFree.H computes
    (F(x+eta v)-F(x))/eta instead).

    The tangent is returned in F's dtype: torch's forward mode gives a
    float32 0-d tensor combined with a Python number a float64 tangent (the
    arclength constraint row of ``continuation`` is one), which would
    otherwise promote the whole float32 Jacobian action."""
    def op(v: torch.Tensor) -> torch.Tensor:
        y, t = torch.func.jvp(f, (x,), (v,))
        return t.to(y.dtype)
    return op


def make_vjp_operator(f: Residual, x: torch.Tensor):
    """Transpose Jacobian action v -> F'(x)^T v via reverse-mode AD (the
    trust-region Cauchy step: grad 0.5||F||^2 = J^T F). One pullback serves
    every v."""
    _, pullback = torch.func.vjp(f, x)

    def op(v: torch.Tensor) -> torch.Tensor:
        return pullback(v)[0]
    return op


_SERIAL = SerialComm()


def default_comm(comm: Comm | None) -> Comm:
    return comm if comm is not None else _SERIAL
