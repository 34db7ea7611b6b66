"""Two-level overlapping Schwarz with a GDSW-type coarse space.

Counterpart of ``trilinos_tpu/precond/two_level_schwarz.py`` (ShyLU-DD /
FROSch: FROSch_TwoLevelPreconditioner with the GDSW/RGDSW coarse spaces).
One-level Schwarz is not numerically scalable: CG iterations grow with the
number of subdomains, and the coarse level keeps them flat.

* first level: the port's ``AdditiveSchwarz`` on the same partition (one
  batched matmul over the padded subdomain inverses);
* coarse space ("rgdsw"): one basis function per subdomain, the inverse
  multiplicity on the interface (a partition of unity over the subdomains
  touching each interface row), extended harmonically into the interiors
  by one ``SparseLu`` of A_II (the interiors are decoupled, so one factor
  serves every subdomain); "constant" is the piecewise-constant
  Nicolaides space;
* coarse operator: A0 = ΦᵀAΦ on the host in float64, an empty subdomain's
  zero diagonal replaced by 1, inverted densely and made exactly symmetric
  (CG needs C = Φ A0⁻¹ Φᵀ symmetric);
* coupling: "additive" M = M1 + C, or the symmetric "hybrid"
  M = C + (I − CA) M1 (I − AC), FROSch's default.

On the device: Φ (npad × nd), A0⁻¹ and, for the hybrid coupling, A stored
through ``choose_format`` (DIA for a stencil-like matrix, so its A·x runs
the DIA kernel). Pad rows of the residual must be zero: the coarse
correction pads and crops it. ``device`` places the tensors (``None``: the
CUDA card).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device, torch_dtype
from ..ops.formats import ROW_ALIGN, CsrHost, choose_format, round_up
from ..ops.matvec import spmv
from ..utils.params import Param
from .base import Preconditioner
from .schwarz import AdditiveSchwarz

_SPECS = {
    "schwarz: num subdomains": Param("schwarz: num subdomains", 4),
    "schwarz: overlap level": Param("schwarz: overlap level", 1),
    "schwarz: combine mode": Param("schwarz: combine mode", "restricted",
                                   choices=("add", "restricted")),
    "coarse space: type": Param("coarse space: type", "rgdsw",
                                choices=("rgdsw", "constant")),
    "coarse space: coupling": Param(
        "coarse space: coupling", "hybrid", choices=("hybrid", "additive"),
        doc="hybrid = symmetric multiplicative M = C + (I-CA) M1 (I-AC) "
            "(FROSch's default, stronger); additive = M1 + C"),
    "schwarz: subdomain ids": Param(
        "schwarz: subdomain ids", None,
        doc="optional length-n part array; default is contiguous chunks"),
    "dtype": Param("dtype", None),
}


def _submatrix(a: CsrHost, n_rows: int, n_cols: int, row_pos: np.ndarray,
               col_pos: np.ndarray) -> CsrHost:
    """A restricted to the rows and columns whose global→local position is
    not -1, renumbered by those positions."""
    rows = a._rows()
    cols = a.cols.astype(np.int64)
    keep = (row_pos[rows] >= 0) & (col_pos[cols] >= 0)
    return CsrHost.from_coo(row_pos[rows[keep]], col_pos[cols[keep]],
                            a.vals[keep], (n_rows, n_cols),
                            sum_duplicates=False)


def _coarse_basis(a: CsrHost, owners: np.ndarray, nd: int,
                 kind: str = "rgdsw") -> np.ndarray:
    """The (n, nd) coarse basis Φ of a partition (``owners[i]`` the
    subdomain of row i), float64."""
    from ..solvers.direct import SparseLu

    n = a.shape[0]
    rows, cols = a._rows(), a.cols.astype(np.int64)
    if kind == "constant":
        phi = np.zeros((n, nd))
        phi[np.arange(n), owners] = 1.0
        return phi
    # the subdomains adjacent to each row (its own and its neighbours');
    # the interface is the rows adjacent to more than one
    adj = np.zeros((n, nd), dtype=bool)
    adj[np.arange(n), owners] = True
    adj[rows, owners[cols]] = True
    multiplicity = adj.sum(axis=1)
    interface = multiplicity > 1
    gamma = np.flatnonzero(interface)
    phi = np.zeros((n, nd))
    phi[gamma] = adj[gamma] / multiplicity[gamma, None]
    inter = np.flatnonzero(~interface)
    if len(inter) and len(gamma):
        # harmonic extension into the interiors: A_II Φ_I = −A_IΓ Φ_Γ
        pos_i = np.full(n, -1, dtype=np.int64)
        pos_i[inter] = np.arange(len(inter))
        pos_g = np.full(n, -1, dtype=np.int64)
        pos_g[gamma] = np.arange(len(gamma))
        a_ii = _submatrix(a, len(inter), len(inter), pos_i, pos_i)
        a_ig = _submatrix(a, len(inter), len(gamma), pos_i, pos_g)
        rhs = np.zeros((len(inter), nd))
        np.subtract.at(rhs, a_ig._rows(),
                       a_ig.vals[:, None]
                       * phi[gamma][a_ig.cols.astype(np.int64)])
        phi[inter] = SparseLu(a_ii).factor().solve(rhs)
    return phi


def _fit_rows(x: torch.Tensor, m: int) -> torch.Tensor:
    """x cropped, or zero-padded, to m rows."""
    if x.shape[0] >= m:
        return x[:m]
    return torch.nn.functional.pad(x, (0, 0, 0, m - x.shape[0]))


class TwoLevelSchwarz(Preconditioner):
    """One-level Schwarz plus a GDSW/RGDSW or constant coarse level."""

    def __init__(self, a, params=None, device=None):
        super().__init__(a, params)
        self.device = resolve_device(device)

    def _do_initialize(self) -> None:
        self.params.validate(_SPECS)
        if not isinstance(self.a, CsrHost):
            raise TypeError("TwoLevelSchwarz expects a CsrHost matrix")

    def _do_compute(self) -> None:
        p = self.params
        nd = int(p["schwarz: num subdomains"])
        dtype = p["dtype"] or self.a.vals.dtype
        n = self.a.shape[0]
        level1 = AdditiveSchwarz(self.a, {
            "schwarz: num subdomains": nd,
            "schwarz: overlap level": int(p["schwarz: overlap level"]),
            "schwarz: combine mode": str(p["schwarz: combine mode"]),
            "schwarz: subdomain ids": p["schwarz: subdomain ids"],
            "dtype": dtype,
        }, device=self.device).compute()
        phi = _coarse_basis(self.a, level1.owners, nd,
                            str(p["coarse space: type"]))
        # A0 = Φᵀ A Φ on the host, exact in float64
        a_phi = np.zeros((n, nd))
        np.add.at(a_phi, self.a._rows(),
                  self.a.vals[:, None] * phi[self.a.cols.astype(np.int64)])
        a0 = phi.T @ a_phi
        for d in range(nd):  # an empty subdomain's coarse block: identity
            if abs(a0[d, d]) < 1e-300:
                a0[d, d] = 1.0
        a0i = np.linalg.inv(a0)
        phi_pad = np.zeros((round_up(n, ROW_ALIGN), nd))
        phi_pad[:n] = phi
        td = torch_dtype(dtype)
        self.set_state(level1, torch.from_numpy(phi_pad).to(self.device, td),
                       torch.from_numpy((a0i + a0i.T) / 2).to(self.device,
                                                              td))

    def set_state(self, level1: AdditiveSchwarz, phi: torch.Tensor,
                  a0_inv: torch.Tensor) -> None:
        """Take a computed first level, the (npad, nd) basis Φ and the
        (nd, nd) A0⁻¹ as they are (``convert.two_level_schwarz_from_numpy``
        carries the JAX package's in); the hybrid coupling's stored A is
        packed here."""
        self.level1, self.phi, self.a0_inv = level1, phi, a0_inv
        self.npad, self.coarse_dim = phi.shape
        self.coupling = str(self.params["coarse space: coupling"])
        if self.coupling == "hybrid":
            self.a_dev = choose_format(self.a, dtype=phi.dtype,
                                       device=phi.device)
        self._computed = True

    def _coarse(self, r2: torch.Tensor) -> torch.Tensor:
        """C r = Φ A0⁻¹ Φᵀ r (two skinny GEMMs and a small one)."""
        phi = self.phi.to(r2.dtype)
        y0 = phi @ (self.a0_inv.to(r2.dtype)
                    @ (phi.T @ _fit_rows(r2, self.npad)))
        return _fit_rows(y0, r2.shape[0])

    def _amul(self, x2: torch.Tensor) -> torch.Tensor:
        """A x for the hybrid coupling, on the stored device format."""
        xp = _fit_rows(x2, self.a_dev.n_rows_pad)
        y = spmv(self.a_dev, xp[:, 0] if x2.shape[1] == 1 else xp)
        return _fit_rows(y[:, None] if y.ndim == 1 else y, x2.shape[0])

    def _apply(self, r: torch.Tensor) -> torch.Tensor:
        was_1d = r.ndim == 1
        r2 = r[:, None] if was_1d else r
        if self.coupling == "additive":
            y = self.level1._apply(r2) + self._coarse(r2)
        else:  # y = C r + (I − C A) M1 (I − A C) r
            y0 = self._coarse(r2)
            y1 = self.level1._apply(r2 - self._amul(y0))
            y = y0 + y1 - self._coarse(self._amul(y1))
        return y[:, 0] if was_1d else y
