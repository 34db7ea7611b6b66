"""GMRES-polynomial preconditioner.

Counterpart of ``trilinos_tpu/precond/poly.py`` (Belos' GmresPolyOp behind
GmresPolySolMgr): set-up runs ``degree`` Arnoldi steps from a seed vector
and keeps the small Hessenberg H and the least-squares coefficients y of
min ‖βe₁ − H y‖ on the host; the apply replays the recurrence

    w₀ = v;  w_{j+1} = (A w_j − Σ_{i≤j} H[i,j] w_i) / H[j+1,j],

accumulating p(A)v = Σ y_j w_j: ``degree`` − 1 operator applies and
axpys, no reduction. The reference reads one host float per dot of its
CGS2 passes; here each pass is one GEMV against the stacked basis and one
read of its coefficients.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device, torch_dtype
from ..ops.formats import ROW_ALIGN, CsrHost, choose_format, round_up
from ..ops.matvec import spmv
from ..utils.params import Param
from .base import Preconditioner

_SPECS = {
    "poly: degree": Param("poly: degree", 10),
    "poly: seed": Param("poly: seed", 0),
    "dtype": Param("dtype", None),
}


class GmresPoly(Preconditioner):
    """p(A) from ``degree`` Arnoldi steps on a seeded normal vector."""

    def __init__(self, a, params=None, device=None):
        super().__init__(a, params)
        self.device = resolve_device(device)

    def _do_initialize(self) -> None:
        self.params.validate(_SPECS)
        if not isinstance(self.a, CsrHost):
            raise TypeError("GmresPoly expects a CsrHost matrix")

    def _pack(self):
        dtype = torch_dtype(self.params["dtype"] or self.a.vals.dtype)
        self._dev = choose_format(self.a, dtype=dtype, device=self.device)
        return dtype

    def _do_compute(self) -> None:
        d = int(self.params["poly: degree"])
        dtype = self._pack()
        n = self.a.shape[0]
        rng = np.random.default_rng(int(self.params["poly: seed"]))
        v0 = np.zeros(round_up(n, ROW_ALIGN))
        v0[:n] = rng.standard_normal(n)
        self.h, self.y, self.degree = gmres_poly_setup(
            lambda v: spmv(self._dev, v),
            torch.from_numpy(v0).to(self.device, dtype), d)

    def set_state(self, h: np.ndarray, y: np.ndarray, degree: int) -> None:
        """Take a given polynomial (H, y, degree) instead of computing one;
        the matrix is packed as ``compute()`` packs it."""
        self._pack()
        self.h, self.y, self.degree = h, y, degree
        self._computed = True

    def _apply(self, r: torch.Tensor) -> torch.Tensor:
        return gmres_poly_apply(lambda v: spmv(self._dev, v), self.h, self.y,
                                self.degree, r)


def gmres_poly_setup(op, v0: torch.Tensor, degree: int, comm=None):
    """Arnoldi with CGS2 from ``v0`` on any operator (generateArnoldiPoly):
    returns (H, y, deg), H and y host float64, deg the degree reached
    (smaller on a breakdown, ‖w‖ < 1e-14). Three host reads a step. With
    ``comm`` the vectors are a rank's rows and every dot and norm is
    reduced over its group, so each rank builds the same polynomial."""
    def norm(v):
        if comm is None:
            return torch.linalg.vector_norm(v)
        return torch.sqrt(comm.psum(v @ v))

    def dots(vj, w):
        return vj @ w if comm is None else comm.psum(vj @ w)

    d = degree
    basis = torch.zeros((d + 1, v0.shape[0]), dtype=v0.dtype,
                        device=v0.device)
    basis[0] = v0 / norm(v0)
    h = np.zeros((d + 1, d))
    deg = d
    for j in range(d):
        w = op(basis[j])
        vj = basis[:j + 1]
        for _ in range(2):  # CGS2: two classical passes
            c = dots(vj, w)
            w = w - vj.T @ c
            h[:j + 1, j] += c.cpu().numpy()
        hj1 = float(norm(w))
        h[j + 1, j] = hj1
        if hj1 < 1e-14:
            deg = j + 1
            break
        basis[j + 1] = w / hj1
    beta_e1 = np.zeros(deg + 1)
    beta_e1[0] = 1.0  # the seed was normalised
    y, *_ = np.linalg.lstsq(h[:deg + 1, :deg], beta_e1, rcond=None)
    return h[:deg + 1, :deg], y, deg


def gmres_poly_apply(op, h: np.ndarray, y: np.ndarray, d: int,
                     r: torch.Tensor) -> torch.Tensor:
    """p(A) r by replaying the Arnoldi recurrence (ApplyArnoldiPoly): d − 1
    operator applies and axpys. The coefficients are rounded to r's dtype
    first, as in the reference."""
    npdt = np.float32 if r.dtype == torch.float32 else np.float64
    h = np.asarray(h, dtype=npdt)
    y = np.asarray(y, dtype=npdt)
    out = float(y[0]) * r
    ws = [r]
    for j in range(d - 1):
        aw = op(ws[j])
        for i in range(j + 1):
            aw = aw - float(h[i, j]) * ws[i]
        ws.append(aw / float(h[j + 1, j]))
        out = out + float(y[j + 1]) * ws[-1]
    return out


def gmres_poly_op(op, v0: torch.Tensor, degree: int = 10):
    """Set-up on ``v0``, then the apply as a closure, for any operator."""
    h, y, deg = gmres_poly_setup(op, v0, degree)
    return lambda r: gmres_poly_apply(op, h, y, deg, r)
