"""ILUT — threshold incomplete LU.

Counterpart of ``trilinos_tpu/precond/ilut.py`` (the analogue of
Ifpack2::ILUT, Ifpack2_ILUT_decl.hpp:91: Saad's dual-threshold ILUT(p, τ),
dropping entries below τ·‖row‖ and keeping the p largest per row in each
factor). The factorization is host code (the port's native ``tt_ilut``, or
the Python row sweep); the apply is ILU(k)'s fixed-sweep Jacobi triangular
solves on the factors, packed with ``choose_format``.
"""
from __future__ import annotations

import heapq

import numpy as np

from ..native import ilut_native
from ..ops.formats import CsrHost
from ..utils.params import Param
from .ilu import Ilu0, pack_factors

_SPECS = {
    "fact: ilut level-of-fill": Param("fact: ilut level-of-fill", 1.5,
                                      doc="keep ~fill·(row nnz) per factor"),
    "fact: drop tolerance": Param("fact: drop tolerance", 1e-4),
    "fact: sweeps": Param("fact: sweeps", 6),
    "dtype": Param("dtype", None),
}


def ilut_factor(a: CsrHost, fill: float = 1.5, droptol: float = 1e-4
                ) -> tuple[CsrHost, CsrHost]:
    """Saad's ILUT(p, τ): returns (L unit-lower incl diag, U upper).

    Uses the port's native C++ row sweep (``tt_ilut``, the same drop and
    keep rules; ``ilut_factor.native_calls``) when the library is
    available; the dict sweep below serves without it
    (``ilut_factor.python_calls``)."""
    n = a.shape[0]
    nat = ilut_native(n, a.row_ptr, a.cols, a.vals.astype(np.float64),
                      fill, droptol)
    if nat is not None:
        ilut_factor.native_calls += 1
        l_ptr, l_cols, l_vals, u_ptr, u_cols, u_vals = nat
        l_rows_r = np.repeat(np.arange(n), np.diff(l_ptr))
        u_rows_r = np.repeat(np.arange(n), np.diff(u_ptr))
        l_m = CsrHost.from_coo(
            np.concatenate([l_rows_r, np.arange(n)]),
            np.concatenate([l_cols.astype(np.int64), np.arange(n)]),
            np.concatenate([l_vals, np.ones(n)]), a.shape,
            sum_duplicates=False)
        u_m = CsrHost.from_coo(u_rows_r, u_cols.astype(np.int64), u_vals,
                               a.shape, sum_duplicates=False)
        return l_m, u_m
    ilut_factor.python_calls += 1
    u_rows: list[dict] = []
    l_rows: list[dict] = []
    for i in range(n):
        cols, vals = a.row(i)
        w = dict(zip(cols.tolist(), vals.tolist()))
        row_norm = float(np.linalg.norm(vals)) or 1.0
        tau = droptol * row_norm
        p_keep = max(int(fill * len(cols)), 1)
        heap = [c for c in w if c < i]
        heapq.heapify(heap)
        seen = set(heap)
        while heap:
            k = heapq.heappop(heap)
            uk = u_rows[k]
            ukk = uk.get(k, 0.0)
            if ukk == 0.0:
                continue
            lik = w[k] / ukk
            if abs(lik) < tau:
                del w[k]
                continue
            w[k] = lik
            for j, uv in uk.items():
                if j > k:
                    fill_new = j not in w
                    w[j] = w.get(j, 0.0) - lik * uv
                    if fill_new and j < i and j not in seen:
                        heapq.heappush(heap, j)
                        seen.add(j)
        lower = {c: v for c, v in w.items() if c < i and abs(v) >= tau}
        upper = {c: v for c, v in w.items() if c >= i
                 and (c == i or abs(v) >= tau)}
        if len(lower) > p_keep:
            keep = sorted(lower, key=lambda c: -abs(lower[c]))[:p_keep]
            lower = {c: lower[c] for c in keep}
        if len(upper) > p_keep + 1:
            keep = sorted((c for c in upper if c != i),
                          key=lambda c: -abs(upper[c]))[:p_keep]
            upper = {c: upper[c] for c in keep} | (
                {i: upper[i]} if i in upper else {})
        if i not in upper:
            upper[i] = row_norm * 1e-12  # zero-pivot guard
        l_rows.append(lower)
        u_rows.append(upper)
    lr, lc, lv, ur, uc, uv = [], [], [], [], [], []
    for i in range(n):
        for c, v in l_rows[i].items():
            lr.append(i)
            lc.append(c)
            lv.append(v)
        lr.append(i)
        lc.append(i)
        lv.append(1.0)
        for c, v in u_rows[i].items():
            ur.append(i)
            uc.append(c)
            uv.append(v)
    l_m = CsrHost.from_coo(np.array(lr), np.array(lc), np.array(lv),
                           a.shape, sum_duplicates=False)
    u_m = CsrHost.from_coo(np.array(ur), np.array(uc), np.array(uv),
                           a.shape, sum_duplicates=False)
    return l_m, u_m


ilut_factor.native_calls = 0
ilut_factor.python_calls = 0


class Ilut(Ilu0):
    """ILUT(p, τ): the threshold factors, applied by the same fixed Jacobi
    sweeps as ILU(k). ``device`` places the factors (``None``: the CUDA
    card)."""

    def _do_initialize(self) -> None:
        self.params.validate(_SPECS)
        if not isinstance(self.a, CsrHost):
            raise TypeError("Ilut expects a CsrHost matrix")

    def _do_compute(self) -> None:
        p = self.params
        dtype = p["dtype"] or self.a.vals.dtype
        l_m, u_m = ilut_factor(self.a, float(p["fact: ilut level-of-fill"]),
                               float(p["fact: drop tolerance"]))
        self.set_state(*pack_factors(l_m, u_m, dtype, self.device),
                       int(p["fact: sweeps"]))
