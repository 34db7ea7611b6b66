"""LinearProblem: the (A, X, B, preconditioners) container.

Counterpart of ``trilinos_tpu/solvers/linear_problem.py``
(``Belos::LinearProblem``): left preconditioning solves M_L A x = M_L b,
right preconditioning solves A M_R u = b with x = M_R u, and both give the
split operator M_L A M_R.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .base import Operator


@dataclasses.dataclass
class LinearProblem:
    op: Operator
    b: torch.Tensor
    x0: torch.Tensor | None = None
    left_prec: Operator | None = None
    right_prec: Operator | None = None
    # optional composable status test (solvers.status), evaluated in the
    # solver loop besides the built-in resnorm/maxiter checks
    stop_test: Callable | None = None

    def set_problem(self) -> "LinearProblem":
        """Finalize (Belos setProblem): default X0 = 0."""
        if self.x0 is None:
            self.x0 = torch.zeros_like(self.b)
        return self

    def composed_op(self) -> Operator:
        op, ml, mr = self.op, self.left_prec, self.right_prec

        def apply(v):
            w = mr(v) if mr is not None else v
            w = op(w)
            return ml(w) if ml is not None else w

        return apply

    def composed_rhs(self) -> torch.Tensor:
        return self.left_prec(self.b) if self.left_prec is not None else self.b

    def recover_solution(self, u: torch.Tensor) -> torch.Tensor:
        """Map the solver-variable solution back to x (right-prec undo)."""
        return self.right_prec(u) if self.right_prec is not None else u

    def residual(self, x: torch.Tensor) -> torch.Tensor:
        """True (unpreconditioned) residual b − A x."""
        return self.b - self.op(x)
