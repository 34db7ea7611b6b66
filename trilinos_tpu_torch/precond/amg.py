"""Smoothed-aggregation AMG preconditioner: the structured branch.

Counterpart of ``SaAmg`` in ``trilinos_tpu/precond/amg.py`` (MueLu's SA-AMG
analogue) for a constant-coefficient :class:`StencilOp` on a grid with an
even dimension: aggregates are 2-blocks per coarsened axis, so

  * the tentative transfers are reshapes (block sum / broadcast, no stored
    P),
  * the smoothed transfers cost one stencil apply each
    (P = (I−ωD⁻¹A)P_t ⇒ Pᵀr = P_tᵀ(r−ωAD⁻¹r)),
  * every coarse level is the exact Galerkin operator in boundary-classified
    form (``precond/structured.py``), stored as a :class:`DiaMatrix`,
  * smoothing is damped Jacobi, or with ``"smoother: type": "chebyshev"``
    a degree sweeps+1 Chebyshev polynomial on the fine level (one stencil
    polynomial apply, λmax from the Gershgorin bound) with damped Jacobi
    on the coarse DIA levels; the coarsest level is a dense pseudo-inverse
    matvec.

Setup is host numpy; the level operators, Jacobi diagonals and coarse
inverse live on ``device``. The uncoupled (CSR) branch is not ported yet
and raises ``NotImplementedError``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device, torch_dtype
from ..ops.formats import CsrHost, ROW_ALIGN, round_up
from ..ops.matvec import spmv
from ..ops.stencil_op import StencilOp
from ..utils.params import Param
from .base import Preconditioner
from .chebyshev import fused_stencil_chebyshev

_SPECS = {
    "max levels": Param("max levels", 10),
    "coarse: max size": Param("coarse: max size", 64),
    "aggregation: min agg size": Param("aggregation: min agg size", 2),
    "sa: damping factor": Param("sa: damping factor", 4.0 / 3.0),
    "smoother: sweeps": Param("smoother: sweeps", 2),
    "smoother: damping factor": Param("smoother: damping factor", 0.8),
    "smoother: type": Param("smoother: type", "jacobi",
                            choices=("jacobi", "chebyshev")),
    "cycle type": Param("cycle type", "V", choices=("V", "W")),
    "fine: matrix-free operator": Param("fine: matrix-free operator",
                                        None),
    "aggregation: type": Param("aggregation: type", "auto",
                               choices=("auto", "uncoupled", "structured")),
    # sparsified Galerkin: coarse-stencil entries below drop_tol·|diag| are
    # lumped into the diagonal (symmetry and row sums preserved)
    "aggregation: drop tol": Param("aggregation: drop tol", 0.005),
    "nullspace: vectors": Param("nullspace: vectors", None),
    "number of equations": Param("number of equations", 1),
    "dtype": Param("dtype", None),
}

_UNCOUPLED = ("the uncoupled SA branch (CSR input, stored P/R) is not "
              "ported yet (ROADMAP.md queue 1 item 5)")


def _structured_block(dims) -> tuple[int, ...]:
    """Per-axis aggregation factor: 2 where the axis is coarsenable."""
    return tuple(2 if (d % 2 == 0 and d >= 4) else 1 for d in dims)


def _is_symmetric_stencil(offsets, coeffs, tol=1e-12) -> bool:
    table = {tuple(o): float(c) for o, c in zip(offsets, coeffs)}
    return all(
        abs(table.get(tuple(-x for x in o), np.inf) - c) <= tol * max(
            1.0, abs(c))
        for o, c in table.items())


def block_pair_sum(r: torch.Tensor, dims, block) -> torch.Tensor:
    """Σ over 2-blocks per coarsened axis: (n_f[,k]) → (n_c[,k]) flat,
    summing x pairs first, then y, then z. ``dims`` = (nx, ny, nz)."""
    nx, ny, nz = dims
    tail = tuple(r.shape[1:])
    t = r[:nx * ny * nz].reshape((nz, ny, nx) + tail)
    for ax, bb in ((2, block[0]), (1, block[1]), (0, block[2])):
        if bb == 2:
            t = t.unflatten(ax, (t.shape[ax] // 2, 2)).sum(ax + 1)
    return t.reshape((-1,) + tail)


def block_pair_dup(e: torch.Tensor, cdims, block) -> torch.Tensor:
    """Duplicate into 2-blocks per coarsened axis: (n_c[,k]) → (n_f[,k])
    flat, the exact adjoint of :func:`block_pair_sum`."""
    cx, cy, cz = cdims
    tail = tuple(e.shape[1:])
    t = e[:cx * cy * cz].reshape((cz, cy, cx) + tail)
    for ax, bb in ((0, block[2]), (1, block[1]), (2, block[0])):
        if bb == 2:
            t = t.repeat_interleave(2, dim=ax)
    return t.reshape((-1,) + tail)


def _pad_rows(v: torch.Tensor, npad: int) -> torch.Tensor:
    out = v.new_zeros((npad,) + tuple(v.shape[1:]))
    out[:v.shape[0]] = v
    return out


def _structured_transfers(op_f, dims, npad_c, block, omega, dinv):
    """Matrix-free smoothed transfers for one structured level.

    restrict(r) = P_tᵀ (r − ω·A(D⁻¹r))    (A symmetric)
    prolong(e)  = t − ω·D⁻¹(A t),  t = P_t e
    ``dinv`` has shape (1,) (constant diagonal) or (npad_f,). Handles
    (n,) and (n, k) operands.
    """
    nx, ny, nz = dims
    bx, by, bz = block
    cdims = (nx // bx, ny // by, nz // bz)
    npad_f = op_f.n_rows_pad
    nrm = float(1.0 / np.sqrt(bx * by * bz))

    def dmul(r):
        return r * (dinv if r.ndim == 1 else dinv[:, None])

    def restrict(r):
        s = r - omega * spmv(op_f, dmul(r))
        return _pad_rows(block_pair_sum(s, dims, block) * nrm, npad_c)

    def prolong(e):
        t = _pad_rows(block_pair_dup(e, cdims, block) * nrm, npad_f)
        return t - omega * dmul(spmv(op_f, t))

    return restrict, prolong


def build_classified_hierarchy(op: StencilOp, max_levels: int,
                               coarse_max: int, damping: float,
                               drop_tol: float, dtype, device):
    """Exact structured hierarchy: level 0 is the StencilOp itself; every
    coarse level is the true Galerkin operator in boundary-classified form,
    materialized as a DiaMatrix on ``device``. Returns
    ``(levels_meta, coarsest_csr, coarsest_npad)`` where each meta is
    ``dict(dev, rep, dims, block, omega)``."""
    from .structured import (ClassifiedStencil, _galerkin_on_grid,
                             galerkin_classified)

    rep = ClassifiedStencil.from_constant(op.offsets, op.coeffs)
    dims = tuple(op.dims)
    dev = op
    levels = []
    for _ in range(max_levels - 1):
        if int(np.prod(dims)) <= coarse_max:
            break
        block = _structured_block(dims)
        if all(b == 1 for b in block):
            break
        rep_c, omega = galerkin_classified(rep, block, damping, drop_tol)
        cdims = tuple(d // b for d, b in zip(dims, block))
        levels.append(dict(dev=dev, rep=rep, dims=dims, block=block,
                           omega=omega))
        if any(c < m for c, m in zip(cdims, rep_c.min_dims())):
            # the coarse grid is smaller than the classified boundary
            # layers: close out with an exact PtAP on the (tiny) real grid
            coarsest = _galerkin_on_grid(rep, dims, block, omega)
            return levels, coarsest, round_up(coarsest.shape[0], ROW_ALIGN)
        rep, dims = rep_c, cdims
        n_c = int(np.prod(cdims))
        dev = rep.materialize_dia(cdims, dtype=dtype,
                                  n_rows_pad=round_up(n_c, 1024),
                                  device=device)
    coarsest = rep.materialize_csr(dims)
    return levels, coarsest, dev.n_rows_pad


class SaAmg(Preconditioner):
    """Smoothed-aggregation AMG cycle (fixed, linear → Krylov-safe).

    ``device`` places the hierarchy's tensors: ``None`` means the CUDA
    card (raises without one), tests pass ``"cpu"``.
    """

    def __init__(self, a, params=None, device=None):
        super().__init__(a, params)
        self.device = resolve_device(device)

    def _do_initialize(self) -> None:
        p = self.params
        p.validate(_SPECS)
        agg_t = p["aggregation: type"]
        cand = (self.a if isinstance(self.a, StencilOp)
                else p["fine: matrix-free operator"])
        can_structured = (
            isinstance(cand, StencilOp)
            and _is_symmetric_stencil(cand.offsets, cand.coeffs)
            and any(b == 2 for b in _structured_block(cand.dims)))
        if agg_t == "structured" and not can_structured:
            raise ValueError(
                "aggregation: type 'structured' needs a symmetric "
                "StencilOp (as the matrix or 'fine: matrix-free operator') "
                "on a grid with at least one even dim >= 4")
        if p["nullspace: vectors"] is not None:
            if agg_t == "structured":
                raise ValueError("'nullspace: vectors' needs the uncoupled "
                                 "hierarchy (structured aggregation "
                                 "carries the constant mode only)")
            raise NotImplementedError(_UNCOUPLED)
        if agg_t == "uncoupled" or not can_structured:
            raise NotImplementedError(_UNCOUPLED)
        fine_op = p["fine: matrix-free operator"]
        if (fine_op is not None and isinstance(self.a, CsrHost)
                and fine_op.shape != self.a.shape):
            raise ValueError("fine operator shape != matrix shape")
        self._stencil = cand

    def _do_compute(self) -> None:
        p = self.params
        self.sweeps = int(p["smoother: sweeps"])
        self.omega = float(p["smoother: damping factor"])
        self.gamma = 2 if p["cycle type"] == "W" else 1
        op = self._stencil
        dtype = torch_dtype(p["dtype"] or op.dtype)
        self.fine_op = op
        self.dtype = dtype
        metas, coarsest_csr, coarsest_npad = build_classified_hierarchy(
            op, int(p["max levels"]), int(p["coarse: max size"]),
            float(p["sa: damping factor"]),
            float(p["aggregation: drop tol"]), dtype, self.device)
        use_cheb = p["smoother: type"] == "chebyshev"
        self.levels = []
        for i, meta in enumerate(metas):
            rep, dims, dev = meta["rep"], meta["dims"], meta["dev"]
            npad_f = dev.n_rows_pad
            npad_c = (metas[i + 1]["dev"].n_rows_pad
                      if i + 1 < len(metas) else coarsest_npad)
            diag_tab = rep.table[(0, 0, 0)]
            if np.ptp(diag_tab) == 0:
                dinv = torch.full((1,), float(1.0 / diag_tab.flat[0]),
                                  dtype=dtype, device=self.device)
            else:
                dv = np.ones(npad_f)
                d = rep.diag_vector(dims)
                dv[: len(d)] = 1.0 / np.where(d != 0, d, 1.0)
                dinv = torch.as_tensor(dv).to(self.device, dtype)
            lvl = dict(a=dev, dinv=dinv, n_f=npad_f, n_c=npad_c, dims=dims,
                       block=meta["block"], omega=meta["omega"])
            if use_cheb and i == 0:
                # degree sweeps+1; the Gershgorin bound stands in for the
                # power-method λmax (an upper bound for constant stencils,
                # no device work at set-up)
                lvl["cheb"] = fused_stencil_chebyshev(
                    op, degree=self.sweeps + 1, lmax=rep.gershgorin())
            self.levels.append(lvl)
        self._set_coarse_inv(coarsest_csr, coarsest_npad, dtype)

    def _set_coarse_inv(self, a: CsrHost, npad: int, dtype) -> None:
        nc = a.shape[0]
        dense = np.eye(npad)
        dense[:nc, :nc] = a.to_dense()
        # pseudo-inverse: semidefinite coarse operators stay stable
        self.coarse_inv = torch.as_tensor(
            np.linalg.pinv(dense, rcond=1e-12)).to(self.device, dtype)

    def n_levels(self) -> int:
        return len(self.levels) + 1

    def state(self) -> dict:
        """The hierarchy's operators and tensors as a plain dict, applied
        with :meth:`apply_state` (``m.apply(r) == m.apply_state(m.state(),
        r)``); ``convert.amg_state_from_jax`` builds one from the JAX
        package's ``SaAmg.state()``."""
        return {"levels": [{"a": lvl["a"], "dinv": lvl["dinv"]}
                           for lvl in self.levels],
                "coarse_inv": self.coarse_inv}

    def apply_state(self, st: dict, r: torch.Tensor) -> torch.Tensor:
        """Cycle reading the level operators, Jacobi diagonals and coarse
        inverse from ``st``; grid shapes and weights come from ``self``."""
        levels = []
        for lvl, s in zip(self.levels, st["levels"], strict=True):
            restrict, prolong = _structured_transfers(
                s["a"], lvl["dims"], lvl["n_c"], lvl["block"],
                lvl["omega"], s["dinv"])
            levels.append(dict(a=s["a"], dinv=s["dinv"], restrict=restrict,
                               prolong=prolong, cheb=lvl.get("cheb")))
        return self._cycle(levels, st["coarse_inv"], 0, r)

    def _smooth(self, lvl, x, b):
        dinv = lvl["dinv"] if b.ndim == 1 else lvl["dinv"][:, None]
        for _ in range(self.sweeps):
            x = x + self.omega * dinv * (b - spmv(lvl["a"], x))
        return x

    def _presmooth(self, lvl, b):
        ch = lvl["cheb"]
        if ch is not None:
            return ch(b)  # zero guess: x = p(A) b
        return self._smooth(lvl, torch.zeros_like(b), b)

    def _postsmooth(self, lvl, x, b):
        ch = lvl["cheb"]
        if ch is not None:
            return x + ch(b - spmv(lvl["a"], x))
        return self._smooth(lvl, x, b)

    def _cycle(self, levels, coarse_inv, k: int,
               b: torch.Tensor) -> torch.Tensor:
        if k == len(levels):
            return coarse_inv @ b
        lvl = levels[k]
        x = self._presmooth(lvl, b)
        # gamma=1: V-cycle; gamma=2: W-cycle
        for _ in range(self.gamma):
            r = b - spmv(lvl["a"], x)
            e_c = self._cycle(levels, coarse_inv, k + 1, lvl["restrict"](r))
            x = x + lvl["prolong"](e_c)
        return self._postsmooth(lvl, x, b)

    def _apply(self, r: torch.Tensor) -> torch.Tensor:
        return self.apply_state(self.state(), r)
