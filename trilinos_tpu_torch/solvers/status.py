"""Composable status tests (stopping criteria).

Counterpart of ``trilinos_tpu/solvers/status.py`` (Belos' StatusTest
hierarchy: MaxIters, GenResNorm with NaN detection, Combo AND/OR). A test
is a function of a :class:`SolverState` of tensors returning a bool tensor
(per column, or a scalar); ``gmres``/``fgmres`` take one as ``stop=`` and
evaluate it every iteration and at every restart, one column at a time.
Passed means stop, OR-combined with the built-in resnorm/maxiter checks.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch


@dataclasses.dataclass
class SolverState:
    """What status tests may read; resnorm is per RHS column."""

    iters: torch.Tensor | int
    resnorm: torch.Tensor
    rhs_norm: torch.Tensor


Test = Callable[[SolverState], torch.Tensor]


def max_iters(maxiter: int) -> Test:
    def check(s: SolverState):
        return torch.as_tensor(s.iters >= maxiter)

    return check


def res_norm(rtol: float, atol: float = 0.0, scaling: str = "rhs") -> Test:
    """||r|| <= rtol · scale + atol per column; scaling 'rhs' (||b||, a zero
    RHS scales by 1) or 'none' (absolute)."""

    def check(s: SolverState):
        if scaling == "rhs":
            scale = torch.where(s.rhs_norm > 0, s.rhs_norm,
                                torch.ones_like(s.rhs_norm))
        elif scaling == "none":
            scale = torch.ones_like(s.resnorm)
        else:
            raise ValueError(f"unknown scaling {scaling!r}")
        return s.resnorm <= rtol * scale + atol

    return check


def nan_check() -> Test:
    """A NaN residual passes (stops the iteration; the solve then reports
    converged=False)."""

    def check(s: SolverState):
        return torch.isnan(s.resnorm)

    return check


def combo_or(tests: Sequence[Test]) -> Test:
    def check(s: SolverState):
        out = tests[0](s)
        for t in tests[1:]:
            out = torch.logical_or(out, t(s))
        return out

    return check


def combo_and(tests: Sequence[Test]) -> Test:
    def check(s: SolverState):
        out = tests[0](s)
        for t in tests[1:]:
            out = torch.logical_and(out, t(s))
        return out

    return check


def standard_stop(rtol: float, atol: float, maxiter: int) -> Test:
    """The default Belos stack: OR(maxiters, all columns' resnorm or NaN)."""
    return combo_or([max_iters(maxiter),
                     lambda s: torch.all(torch.logical_or(
                         res_norm(rtol, atol)(s), nan_check()(s)))])
