"""Hiptmair two-space (hybrid) smoother and preconditioner.

Counterpart of ``trilinos_tpu/precond/hiptmair.py`` (the analogue of
Ifpack2::Hiptmair, Ifpack2_Hiptmair_decl.hpp). For curl-curl systems
A = CᵀC + σM on edge unknowns, point smoothers stall on the gradient
near-null space of CᵀC. One apply is

  1. damped-Jacobi sweeps on the edge space from a zero guess,
  2. a correction in the auxiliary node space: the residual projected
     through the discrete gradient D (edges × nodes), the auxiliary
     preconditioner (any ``create`` name; CHEBYSHEV by default) on
     A_aux = Dᵀ A D, prolongated back by D,
  3. damped-Jacobi sweeps on the edge space again (symmetric with 1).

A and A_aux are packed with ``choose_format``, D and Dᵀ as rectangular ELL
(``amg._pack_rect``). ``device`` places the tensors (``None``: the CUDA
card); the auxiliary preconditioner is built on the same device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device, torch_dtype
from ..ops.formats import ROW_ALIGN, CsrHost, choose_format, round_up
from ..ops.matrix_ops import spgemm
from ..ops.matvec import spmv
from ..utils.params import Param
from .amg import _pack_rect
from .base import Preconditioner, create

_SPECS = {
    "hiptmair: smoother sweeps": Param("hiptmair: smoother sweeps", 2),
    "hiptmair: damping factor": Param("hiptmair: damping factor", 0.8),
    "hiptmair: aux preconditioner": Param("hiptmair: aux preconditioner",
                                          "CHEBYSHEV"),
    "hiptmair: aux parameters": Param("hiptmair: aux parameters", None),
    "dtype": Param("dtype", None),
}


class Hiptmair(Preconditioner):
    """``create("HIPTMAIR", a, params, aux_op=D)``: ``a`` is the edge-space
    matrix and ``aux_op`` the discrete gradient D (both CsrHost, D of shape
    edges × nodes). A_aux = Dᵀ A D is formed at ``compute()``."""

    def __init__(self, a, params=None, aux_op: CsrHost | None = None,
                 device=None):
        super().__init__(a, params)
        self.d_host = aux_op
        self.device = resolve_device(device)

    def _do_initialize(self) -> None:
        self.params.validate(_SPECS)
        if not isinstance(self.a, CsrHost):
            raise TypeError("Hiptmair expects a CsrHost edge matrix")
        if self.d_host is None:
            raise ValueError("Hiptmair needs aux_op=D (discrete gradient)")

    def _do_compute(self) -> None:
        p = self.params
        dtype = p["dtype"] or self.a.vals.dtype
        d = self.d_host
        a_aux = spgemm(d.transpose(), spgemm(self.a, d))
        n_e = round_up(self.a.shape[0], ROW_ALIGN)
        n_n = round_up(a_aux.shape[0], ROW_ALIGN)
        self.a_dev = choose_format(self.a, dtype=dtype, device=self.device)
        self.aux_dev = choose_format(a_aux, dtype=dtype, device=self.device)
        self.d_dev = _pack_rect(d, dtype, n_e, self.device)
        self.dt_dev = _pack_rect(d.transpose(), dtype, n_n, self.device)
        dg = self.a.diagonal().astype(np.float64)
        dinv = np.ones(n_e)
        dinv[:len(dg)] = 1.0 / np.where(dg != 0, dg, 1.0)
        self.dinv_e = torch.from_numpy(dinv).to(self.device,
                                                torch_dtype(dtype))
        self.sweeps = int(p["hiptmair: smoother sweeps"])
        self.omega = float(p["hiptmair: damping factor"])
        self.aux_prec = create(str(p["hiptmair: aux preconditioner"]), a_aux,
                               p["hiptmair: aux parameters"],
                               device=self.device).compute()

    def _smooth(self, x, b):
        di = self.dinv_e if b.ndim == 1 else self.dinv_e[:, None]
        for _ in range(self.sweeps):
            x = x + self.omega * di * (b - spmv(self.a_dev, x))
        return x

    def _apply(self, r: torch.Tensor) -> torch.Tensor:
        x = self._smooth(torch.zeros_like(r), r)  # edge pre-smooth
        r_n = spmv(self.dt_dev, r - spmv(self.a_dev, x))  # to the nodes
        x = x + spmv(self.d_dev, self.aux_prec.apply(r_n))  # correction
        return self._smooth(x, r)  # edge post-smooth
