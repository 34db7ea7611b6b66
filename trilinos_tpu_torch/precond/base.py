"""Preconditioner lifecycle: initialize → compute → apply.

Counterpart of ``Preconditioner`` in ``trilinos_tpu/precond/base.py``
(Ifpack2's interface): ``initialize()`` does structure-only setup,
``compute()`` the numeric setup that produces device tensors, and
``apply(x)`` is usable directly as the ``prec=`` argument of a solver.
The string factory comes with the other preconditioners.
"""
from __future__ import annotations

import torch

from ..utils.params import ParameterList, make_params


class Preconditioner:
    """Base lifecycle: initialize → compute → apply."""

    def __init__(self, a, params: ParameterList | dict | None = None):
        self.a = a
        self.params = make_params(params)
        self._initialized = False
        self._computed = False

    def initialize(self) -> "Preconditioner":
        self._do_initialize()
        self._initialized = True
        return self

    def compute(self) -> "Preconditioner":
        if not self._initialized:
            self.initialize()
        self._do_compute()
        self._computed = True
        return self

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        if not self._computed:
            raise RuntimeError(
                f"{type(self).__name__}.apply() before compute()")
        return self._apply(x)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(x)

    def _do_initialize(self) -> None:
        pass

    def _do_compute(self) -> None:
        pass

    def _apply(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError
