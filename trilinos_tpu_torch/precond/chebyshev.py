"""Chebyshev polynomial preconditioning.

Counterpart of ``trilinos_tpu/precond/chebyshev.py`` (the analogue of
Ifpack2::Chebyshev: λmax from a power method on D⁻¹A unless given, times
a boost factor; λmin = λmax / ratio):

* ``Chebyshev``: the class for a stored matrix. ``compute()`` packs it
  with ``choose_format`` (DIA on a stencil matrix, so its SpMVs run the
  DIA kernel on the card) and runs the power method from a seeded numpy
  start over all padded entries, as the reference does; ``apply`` is the
  degree-d semi-iteration on the Jacobi-scaled system with a zero initial
  guess, one SpMV a degree past the first;
* ``fused_stencil_chebyshev``: the same semi-iteration on a matrix-free
  stencil with a constant diagonal, one stencil polynomial apply
  (``ops/stencil_poly.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device, torch_dtype
from ..ops.formats import ROW_ALIGN, CsrHost, choose_format, round_up
from ..ops.matvec import spmv
from ..ops.stencil_op import StencilOp
from ..ops.stencil_poly import stencil_chebyshev_setup, stencil_poly_apply
from ..utils.params import Param
from .base import Preconditioner

_SPECS = {
    "chebyshev: degree": Param("chebyshev: degree", 1),
    "chebyshev: max eigenvalue": Param("chebyshev: max eigenvalue", None),
    "chebyshev: min eigenvalue": Param("chebyshev: min eigenvalue", None),
    "chebyshev: ratio eigenvalue": Param("chebyshev: ratio eigenvalue", 30.0),
    "chebyshev: eigenvalue max iterations": Param(
        "chebyshev: eigenvalue max iterations", 10),
    "chebyshev: boost factor": Param("chebyshev: boost factor", 1.1),
    "dtype": Param("dtype", None),
}


class Chebyshev(Preconditioner):
    """Chebyshev semi-iteration on D⁻¹A for a ``CsrHost`` matrix."""

    def __init__(self, a, params=None, device=None):
        super().__init__(a, params)
        self.device = resolve_device(device)

    def _do_initialize(self) -> None:
        self.params.validate(_SPECS)
        if not isinstance(self.a, CsrHost):
            raise TypeError("Chebyshev expects a CsrHost matrix")

    def _power_method(self, iters: int) -> float:
        """λmax of D⁻¹A by power iteration from a seed-0 normal start over
        all padded entries; one host read an iteration."""
        rng = np.random.default_rng(0)
        v = torch.from_numpy(rng.standard_normal(self.dinv.shape[0])).to(
            self.device, self.dinv.dtype)
        v = v / torch.linalg.vector_norm(v)
        lam = 1.0
        for _ in range(iters):
            w = self.dinv * spmv(self._dev, v)
            lam = float(torch.linalg.vector_norm(w))
            v = w / max(lam, 1e-30)
        return lam

    def _do_compute(self) -> None:
        p = self.params
        dtype = torch_dtype(p["dtype"] or self.a.vals.dtype)
        n = self.a.shape[0]
        self._dev = choose_format(self.a, dtype=dtype, device=self.device)
        d = self.a.diagonal().astype(np.float64)
        dinv = np.ones(round_up(n, ROW_ALIGN))
        dinv[:n] = 1.0 / np.where(d != 0, d, 1.0)
        self.dinv = torch.from_numpy(dinv).to(self.device, dtype)
        lmax = p["chebyshev: max eigenvalue"]
        if lmax is None:
            lmax = self._power_method(
                int(p["chebyshev: eigenvalue max iterations"]))
            lmax *= float(p["chebyshev: boost factor"])
        lmin = p["chebyshev: min eigenvalue"]
        if lmin is None:
            lmin = lmax / float(p["chebyshev: ratio eigenvalue"])
        self.lmax = float(lmax)
        self.lmin = float(lmin)
        self.degree = int(p["chebyshev: degree"])

    def _apply(self, b: torch.Tensor) -> torch.Tensor:
        """Chebyshev semi-iteration on the Jacobi-scaled system with a zero
        initial guess (Saad, Iterative Methods, Alg. 12.1)."""
        dinv = self.dinv if b.ndim == 1 else self.dinv[:, None]
        theta = (self.lmax + self.lmin) / 2
        delta = (self.lmax - self.lmin) / 2
        sigma1 = theta / delta
        rho = 1.0 / sigma1
        d_vec = dinv * b / theta  # z0 = D⁻¹ r0 with r0 = b
        x = d_vec
        r = b
        for _ in range(self.degree - 1):
            r = r - spmv(self._dev, d_vec)
            rho_new = 1.0 / (2 * sigma1 - rho)
            d_vec = (rho_new * rho) * d_vec + (2 * rho_new / delta) * (
                dinv * r)
            x = x + d_vec
            rho = rho_new
        return x


def fused_stencil_chebyshev(op: StencilOp, degree: int,
                            lmax: float | None = None,
                            lmin: float | None = None, ratio: float = 30.0,
                            boost: float = 1.1, eig_iters: int = 10,
                            device=None):
    """Chebyshev preconditioner apply ``b -> p(A) b`` for a stencil with a
    constant diagonal, usable as ``prec=`` in any solver. ``lmax``/``lmin``
    bound the Jacobi-scaled operator D⁻¹A; without ``lmax`` the power
    method runs on ``device`` (``None`` means the CUDA card)."""
    if not isinstance(op, StencilOp):
        raise TypeError("fused_stencil_chebyshev expects a StencilOp")
    stages = stencil_chebyshev_setup(op, degree, lmax, lmin, ratio, boost,
                                     eig_iters, device)
    return lambda b: stencil_poly_apply(op, stages, b)
