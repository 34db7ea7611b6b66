"""Direct solver as a preconditioner (Ifpack2's Amesos2Wrapper).

Counterpart of ``trilinos_tpu/precond/direct_prec.py``
(Ifpack2_Details_Amesos2Wrapper_decl.hpp): ``compute()`` factors the host
matrix with ``solvers.direct`` (KLU2: ``SparseLu``; TACHO or CHOLMOD:
``SparseCholesky``), builds the dense inverse from n unit-vector solves
into an npad × npad identity (so pad rows stay identity) and uploads it
once; an apply is one matmul on the device.

The inverse is O(n²) in memory and its set-up is n host solves, by the
reference's design: it is meant for coarse grids and subdomains of a few
thousand rows (4,096 rows hold 134 MB in float64), not for a fine grid.
``device`` places the inverse (``None``: the CUDA card).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device, torch_dtype
from ..ops.formats import ROW_ALIGN, CsrHost, round_up
from ..utils.params import Param
from .base import Preconditioner

_SPECS = {
    "dtype": Param("dtype", None),
    # Amesos2 backend: "KLU2" = LU with partial pivoting (any matrix);
    # "TACHO"/"CHOLMOD" = LL^T (SPD only, half the fill and work)
    "solver": Param("solver", "KLU2", choices=("KLU2", "TACHO", "CHOLMOD")),
}


class DirectPrec(Preconditioner):
    """Exact solve by a dense inverse of the sparse factors."""

    def __init__(self, a, params=None, device=None):
        super().__init__(a, params)
        self.device = resolve_device(device)

    def _do_initialize(self) -> None:
        self.params.validate(_SPECS)
        if not isinstance(self.a, CsrHost):
            raise TypeError("DirectPrec expects a CsrHost matrix")

    def _do_compute(self) -> None:
        from ..solvers.direct import SparseCholesky, SparseLu

        dtype = self.params["dtype"] or self.a.vals.dtype
        n = self.a.shape[0]
        cls = (SparseCholesky if self.params["solver"] in ("TACHO", "CHOLMOD")
               else SparseLu)
        self.factorization = cls(self.a).factor()
        inv = np.eye(round_up(n, ROW_ALIGN))
        inv[:n, :n] = self.factorization.solve(np.eye(n))
        self.set_state(torch.from_numpy(inv).to(self.device,
                                                torch_dtype(dtype)))

    def set_state(self, inv_dense: torch.Tensor) -> None:
        """Take the (npad, npad) inverse as it is
        (``convert.direct_prec_from_numpy`` carries the JAX package's in)."""
        self.inv_dense = inv_dense
        self._computed = True

    def _apply(self, r: torch.Tensor) -> torch.Tensor:
        """inv @ r in the inverse's dtype, returned in r's; the three pad
        cases of the reference: r as long as the inverse, longer (identity
        on the tail) or shorter (zero-padded, then cropped)."""
        inv = self.inv_dense
        m, npad_in = inv.shape[0], r.shape[0]
        rr = r.to(inv.dtype)
        if npad_in == m:
            y = inv @ rr
        elif npad_in > m:
            y = torch.cat([inv @ rr[:m], rr[m:]])
        else:
            rp = rr.new_zeros((m,) + r.shape[1:])
            rp[:npad_in] = rr
            y = (inv @ rp)[:npad_in]
        return y.to(r.dtype)
