"""Point relaxation (Jacobi family) and block-Jacobi preconditioners.

Counterpart of ``trilinos_tpu/precond/jacobi.py`` (Ifpack2::Relaxation's
"relaxation: type"/"sweeps"/"damping factor" and Ifpack2::BlockRelaxation
with dense containers):

* ``Relaxation``: damped Jacobi or l1 Jacobi. More than one sweep needs the
  operator, which ``compute()`` packs with ``choose_format`` (DIA on a
  stencil matrix, so its sweeps run the DIA kernel on the card).
* ``BlockJacobi``: the dense diagonal blocks are inverted on the host at
  ``compute()`` and applied as one batched (nb, bs, bs) × (nb, bs, k)
  matmul.

``device`` places the tensors: ``None`` means the CUDA card and raises
without one.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device, torch_dtype
from ..ops.formats import ROW_ALIGN, CsrHost, choose_format, round_up
from ..ops.matvec import spmv
from ..utils.params import Param
from .base import Preconditioner

_RELAX_SPECS = {
    "relaxation: type": Param("relaxation: type", "Jacobi",
                              choices=("Jacobi", "l1 Jacobi")),
    "relaxation: sweeps": Param("relaxation: sweeps", 1),
    "relaxation: damping factor": Param("relaxation: damping factor", 1.0),
    "relaxation: l1 eta": Param("relaxation: l1 eta", 1.5),
    "dtype": Param("dtype", None),
}


class Relaxation(Preconditioner):
    """Damped (l1-)Jacobi: apply ≈ sweeps of y ← y + ω D⁻¹ (x − A y)."""

    def __init__(self, a, params=None, device=None):
        super().__init__(a, params)
        self.device = resolve_device(device)

    def _do_initialize(self) -> None:
        self.params.validate(_RELAX_SPECS)
        if not isinstance(self.a, CsrHost):
            raise TypeError("Relaxation expects a CsrHost matrix")

    def _do_compute(self) -> None:
        p = self.params
        dtype = p["dtype"] or self.a.vals.dtype
        n = self.a.shape[0]
        d = self.a.diagonal().astype(np.float64)
        if p["relaxation: type"] == "l1 Jacobi":
            # l1 variant: add η · (off-diagonal absolute row sums)
            rows = self.a._rows()
            off = self.a.cols != rows
            abs_sum = np.zeros(n)
            np.add.at(abs_sum, rows[off], np.abs(self.a.vals[off]))
            d = d + p["relaxation: l1 eta"] * abs_sum
        dinv = np.ones(round_up(n, ROW_ALIGN))
        dinv[:n] = 1.0 / np.where(d != 0, d, 1.0)
        self.set_state(
            torch.from_numpy(dinv).to(self.device, torch_dtype(dtype)),
            float(p["relaxation: damping factor"]),
            int(p["relaxation: sweeps"]))

    def set_state(self, dinv: torch.Tensor, omega: float, sweeps: int) -> None:
        """Install the numeric state, which makes the preconditioner ready
        to apply: the padded inverse diagonal, the damping factor and the
        sweep count; more than one sweep packs the operator with
        ``choose_format`` in dinv's dtype."""
        self.dinv, self.omega, self.sweeps = dinv, float(omega), int(sweeps)
        self._dev = (choose_format(self.a, dtype=dinv.dtype,
                                   device=dinv.device)
                     if self.sweeps > 1 else None)
        self._computed = True

    def _apply(self, x: torch.Tensor) -> torch.Tensor:
        dinv = self.dinv if x.ndim == 1 else self.dinv[:, None]
        y = self.omega * dinv * x
        for _ in range(self.sweeps - 1):
            r = x - spmv(self._dev, y)
            y = y + self.omega * dinv * r
        return y


_BJ_SPECS = {
    "partitioner: block size": Param("partitioner: block size", 4),
    "dtype": Param("dtype", None),
}


class BlockJacobi(Preconditioner):
    """Non-overlapping block Jacobi with dense inverted diagonal blocks."""

    def __init__(self, a, params=None, device=None):
        super().__init__(a, params)
        self.device = resolve_device(device)

    def _do_initialize(self) -> None:
        self.params.validate(_BJ_SPECS)

    def _do_compute(self) -> None:
        bs = int(self.params["partitioner: block size"])
        dtype = self.params["dtype"] or self.a.vals.dtype
        n = self.a.shape[0]
        nb = -(-n // bs)
        nb_pad = -(-round_up(nb * bs, ROW_ALIGN) // bs)
        blocks = np.tile(np.eye(bs), (nb_pad, 1, 1))
        for ib in range(nb):
            lo, hi = ib * bs, min((ib + 1) * bs, n)
            blk = np.eye(bs)
            for local_i, i in enumerate(range(lo, hi)):
                cols, vals = self.a.row(i)
                sel = (cols >= lo) & (cols < hi)
                blk[local_i, :] = 0
                blk[local_i, cols[sel] - lo] = vals[sel]
            # singular guard: fall back to the diagonal
            if abs(np.linalg.det(blk)) < 1e-300:
                blk = np.diag(np.where(np.diag(blk) != 0, np.diag(blk), 1.0))
            blocks[ib] = np.linalg.inv(blk)
        self.block_size = bs
        self.n_pad = nb_pad * bs
        self.inv_blocks = torch.from_numpy(blocks).to(self.device,
                                                      torch_dtype(dtype))

    def _apply(self, x: torch.Tensor) -> torch.Tensor:
        bs = self.block_size
        x2 = x[:, None] if x.ndim == 1 else x
        npad_in = x2.shape[0]
        if npad_in < self.n_pad:
            x2 = torch.nn.functional.pad(x2, (0, 0, 0, self.n_pad - npad_in))
        xb = x2[:self.n_pad].reshape(-1, bs, x2.shape[1])
        yb = torch.matmul(self.inv_blocks, xb.to(self.inv_blocks.dtype))
        y = yb.reshape(-1, x2.shape[1])[:npad_in]
        if y.shape[0] < npad_in:
            y = torch.nn.functional.pad(y, (0, 0, 0, npad_in - y.shape[0]))
        return y[:, 0] if x.ndim == 1 else y
