"""Multicolor Gauss-Seidel relaxation.

Counterpart of ``trilinos_tpu/precond/multicolor_gs.py`` (the analogue of
Ifpack2's multithreaded Gauss-Seidel, Ifpack2_Relaxation_decl.hpp:238, on
a distance-1 greedy colouring): rows of one colour share no edge, so each
colour updates as a masked Jacobi step from the freshest values of the
others; a stencil matrix colours red-black. One sweep is one SpMV and one
masked update per colour, on A packed with ``choose_format`` (DIA on a
stencil matrix, so on the card's kernel). ``device`` places the tensors
(``None``: the CUDA card).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device, torch_dtype
from ..ops.formats import ROW_ALIGN, CsrHost, choose_format, round_up
from ..ops.matvec import spmv
from ..utils.params import Param
from .base import Preconditioner


def greedy_color(a: CsrHost) -> np.ndarray:
    """Distance-1 greedy colouring (KokkosGraph_Distance1Color analogue)."""
    n = a.shape[0]
    color = np.full(n, -1, dtype=np.int64)
    for i in range(n):
        cols, _ = a.row(i)
        used = set(int(color[c]) for c in cols if c != i and c < n
                   and color[c] >= 0)
        c = 0
        while c in used:
            c += 1
        color[i] = c
    return color


_SPECS = {
    "relaxation: sweeps": Param("relaxation: sweeps", 1),
    "relaxation: damping factor": Param("relaxation: damping factor", 1.0),
    "relaxation: symmetric": Param("relaxation: symmetric", False),
    "dtype": Param("dtype", None),
}


class MulticolorGaussSeidel(Preconditioner):
    """Coloured (symmetric) Gauss-Seidel sweeps as a preconditioner."""

    def __init__(self, a, params=None, device=None):
        super().__init__(a, params)
        self.device = resolve_device(device)

    def _do_initialize(self) -> None:
        self.params.validate(_SPECS)
        if not isinstance(self.a, CsrHost):
            raise TypeError("MulticolorGaussSeidel expects CsrHost")
        self.colors = greedy_color(self.a)
        self.n_colors = int(self.colors.max()) + 1

    def _do_compute(self) -> None:
        p = self.params
        dtype = torch_dtype(p["dtype"] or self.a.vals.dtype)
        n = self.a.shape[0]
        npad = round_up(n, ROW_ALIGN)
        d = self.a.diagonal()
        dinv = np.ones(npad)
        dinv[:n] = 1.0 / np.where(d != 0, d, 1.0)
        self.dinv = torch.from_numpy(dinv).to(self.device, dtype)
        masks = np.zeros((self.n_colors, npad))
        for c in range(self.n_colors):
            masks[c, :n] = self.colors == c
        self.masks = torch.from_numpy(masks).to(self.device, dtype)
        self._dev = choose_format(self.a, dtype=dtype, device=self.device)
        self.sweeps = int(p["relaxation: sweeps"])
        self.omega = float(p["relaxation: damping factor"])
        self.symmetric = bool(p["relaxation: symmetric"])

    def _one_color(self, c: int, x, b):
        mask = self.masks[c] if b.ndim == 1 else self.masks[c][:, None]
        dinv = self.dinv if b.ndim == 1 else self.dinv[:, None]
        return x + self.omega * mask * dinv * (b - spmv(self._dev, x))

    def _apply(self, b: torch.Tensor) -> torch.Tensor:
        x = torch.zeros_like(b)
        order = list(range(self.n_colors))
        for _ in range(self.sweeps):
            for c in order:
                x = self._one_color(c, x, b)
            if self.symmetric:
                for c in reversed(order):
                    x = self._one_color(c, x, b)
        return x
