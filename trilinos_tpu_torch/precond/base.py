"""Preconditioner lifecycle: initialize → compute → apply.

Counterpart of ``Preconditioner`` in ``trilinos_tpu/precond/base.py``
(Ifpack2's interface): ``initialize()`` does structure-only setup,
``compute()`` the numeric setup that produces device tensors, and
``apply(x)`` is usable directly as the ``prec=`` argument of a solver.
``create`` is the string factory (Ifpack2::Factory's dispatch) with the
reference's full name table.
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


def create(name: str, a, params: ParameterList | dict | None = None,
           **kw) -> Preconditioner:
    """String factory: name → preconditioner instance (not yet computed),
    ``kw`` (such as ``device=``) passed to its constructor. Names follow the
    reference's factory strings, case-insensitive."""
    from .amg import SaAmg
    from .block_amg import BlockStructuredAmg
    from .chebyshev import Chebyshev
    from .containers import BlockRelaxation
    from .direct_prec import DirectPrec
    from .hiptmair import Hiptmair
    from .ilu import Ilu0
    from .ilut import Ilut
    from .jacobi import BlockJacobi, Relaxation
    from .multicolor_gs import MulticolorGaussSeidel
    from .poly import GmresPoly
    from .schwarz import AdditiveSchwarz
    from .two_level_schwarz import TwoLevelSchwarz

    key = name.strip().upper()
    table = {
        "JACOBI": Relaxation,
        "RELAXATION": Relaxation,
        "CHEBYSHEV": Chebyshev,
        "RILUK": Ilu0,
        "RBILUK": Ilu0,  # "fact: block size" > 1: block-level ILU(k)
        "ILU": Ilu0,
        "ILU(0)": Ilu0,
        "ILUT": Ilut,
        "GMRESPOLY": GmresPoly,
        "POLY": GmresPoly,
        "BLOCK RELAXATION": BlockRelaxation,
        "TRIDI": BlockRelaxation,
        "BANDED RELAXATION": BlockRelaxation,
        "DATABASE SCHWARZ": BlockRelaxation,
        "BLOCK_JACOBI": BlockJacobi,
        "MT GAUSS-SEIDEL": MulticolorGaussSeidel,
        "GAUSS-SEIDEL": MulticolorGaussSeidel,
        "SCHWARZ": AdditiveSchwarz,
        "ADDITIVE SCHWARZ": AdditiveSchwarz,
        "TWO-LEVEL SCHWARZ": TwoLevelSchwarz,
        "FROSCH": TwoLevelSchwarz,
        "GDSW": TwoLevelSchwarz,
        "HIPTMAIR": Hiptmair,
        "AMESOS2": DirectPrec,
        "DIRECT": DirectPrec,
        "KLU2": DirectPrec,
        "TACHO": DirectPrec,
        "CHOLMOD": DirectPrec,
        "SA-AMG": SaAmg,
        "BLOCK SA-AMG": BlockStructuredAmg,
        "MUELU": SaAmg,
        "AMG": SaAmg,
    }
    if key not in table:
        raise ValueError(f"unknown preconditioner {name!r}; "
                         f"valid: {sorted(table)}")
    if key in ("TACHO", "CHOLMOD"):
        # a copy: adding the backend default must not change a caller's
        # ParameterList (it may be reused for another create())
        params = make_params(params).copy()
        if "solver" not in params:
            params["solver"] = key
    return table[key](a, params, **kw)
