"""Preconditioner lifecycle: initialize → compute → apply.

Counterpart of ``Preconditioner`` in ``trilinos_tpu/precond/base.py``
(Ifpack2's interface): ``initialize()`` does structure-only setup,
``compute()`` the numeric setup that produces device tensors, and
``apply(x)`` is usable directly as the ``prec=`` argument of a solver.
``create`` is the string factory (Ifpack2::Factory's dispatch) with the
reference's full name table; a name whose class is not ported yet raises
``NotImplementedError`` naming the ROADMAP item that holds it.
"""
from __future__ import annotations

import torch

from ..utils.params import ParameterList, make_params

# names of the reference's table whose classes are not ported yet, with the
# ROADMAP queue 1 item that holds each
_LATER = {
    "CHEBYSHEV": 5, "GMRESPOLY": 5, "POLY": 5,
    "RILUK": 7, "RBILUK": 7, "ILU": 7, "ILU(0)": 7, "ILUT": 7,
    "BLOCK RELAXATION": 7, "TRIDI": 7, "BANDED RELAXATION": 7,
    "DATABASE SCHWARZ": 7, "MT GAUSS-SEIDEL": 7, "GAUSS-SEIDEL": 7,
    "SCHWARZ": 7, "ADDITIVE SCHWARZ": 7, "TWO-LEVEL SCHWARZ": 7,
    "FROSCH": 7, "GDSW": 7, "HIPTMAIR": 7, "AMESOS2": 7, "DIRECT": 7,
    "KLU2": 7, "TACHO": 7, "CHOLMOD": 7,
}


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


def create(name: str, a, params: ParameterList | dict | None = None,
           **kw) -> Preconditioner:
    """String factory: name → preconditioner instance (not yet computed),
    ``kw`` (such as ``device=``) passed to its constructor. Names follow the
    reference's factory strings, case-insensitive."""
    from .amg import SaAmg
    from .block_amg import BlockStructuredAmg
    from .jacobi import BlockJacobi, Relaxation

    key = name.strip().upper()
    table = {
        "JACOBI": Relaxation,
        "RELAXATION": Relaxation,
        "BLOCK_JACOBI": BlockJacobi,
        "SA-AMG": SaAmg,
        "BLOCK SA-AMG": BlockStructuredAmg,
        "MUELU": SaAmg,
        "AMG": SaAmg,
    }
    if key in _LATER:
        raise NotImplementedError(
            f"preconditioner {name!r} is not ported yet (ROADMAP.md queue 1 "
            f"item {_LATER[key]})")
    if key not in table:
        raise ValueError(f"unknown preconditioner {name!r}; "
                         f"valid: {sorted([*table, *_LATER])}")
    return table[key](a, params, **kw)
