"""Boundary-classified stencil algebra for structured-aggregation AMG.

Counterpart of ``trilinos_tpu/precond/structured.py`` (a numpy copy: the
port imports nothing of the JAX package). The exact Galerkin coarse
operator of a plane-masked constant stencil is not constant-coefficient,
but each level's coefficient at offset ``o`` depends only on the per-axis
clamped distance to the grid faces — a "class" ``(cx, cy, cz)`` with
``c ∈ {0..L-1, interior, L-1..0 from the high face}``. That makes the
coarse operator

  * extractable exactly from one small probe-grid PᵀAP (any grid with
    dims ≥ 2L+1 per axis contains every class combination),
  * materializable on any grid as a stored DIA matrix (per-offset value
    vectors by class lookup), and
  * verifiable against a directly computed PᵀAP on a larger probe.

Setup is host numpy and O(probe³) per level, independent of the real grid
size; only :meth:`ClassifiedStencil.materialize_dia` touches the real grid.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..galeri.stencils import stencil_csr, stencil_dia
from ..ops.formats import CsrHost
from ..ops.matrix_ops import ptap, spadd
from .amg import smooth_prolongator

Offset = tuple[int, int, int]


def _cls_index(x: np.ndarray, d: int, L: int) -> np.ndarray:
    """Per-axis class of coordinate x on a grid of size d with layer
    depth L: 0..L-1 = distance from the low face, L = interior,
    L+1..2L = 2L - (distance from the high face)."""
    cls = np.minimum(x, L)
    high = d - 1 - x
    return np.where(high < L, 2 * L - high, cls)


@dataclasses.dataclass(frozen=True)
class ClassifiedStencil:
    """Grid-size-independent operator: ``coeff(row, o) =
    table[o][cls(ix), cls(iy), cls(iz)]`` (gid = ix + nx·(iy + ny·iz))."""

    offsets: tuple[Offset, ...]
    L: tuple[int, int, int]
    table: dict  # Offset -> np.float64 array (2Lx+1, 2Ly+1, 2Lz+1)

    @classmethod
    def from_constant(cls, offsets, coeffs) -> "ClassifiedStencil":
        """A plane-masked constant stencil (StencilOp semantics): the
        class table holds c where the neighbour is in-grid, 0 where the
        Dirichlet closure truncates it."""
        offsets = tuple(tuple(int(x) for x in o) for o in offsets)
        L = tuple(max((abs(o[ax]) for o in offsets), default=0)
                  for ax in range(3))
        table = {}
        axis_cls = [np.arange(2 * L[ax] + 1) for ax in range(3)]
        for o, c in zip(offsets, coeffs):
            valid = np.ones((2 * L[0] + 1, 2 * L[1] + 1, 2 * L[2] + 1),
                            dtype=bool)
            for ax in range(3):
                t = axis_cls[ax]
                low_ok = np.where(t < L[ax], t + o[ax] >= 0, True)
                high_ok = np.where(t > L[ax], o[ax] <= 2 * L[ax] - t, True)
                shape = [1, 1, 1]
                shape[ax] = len(t)
                valid &= (low_ok & high_ok).reshape(shape)
            table[o] = np.where(valid, float(c), 0.0)
        return cls(offsets=offsets, L=L, table=table)

    def reach(self) -> tuple[int, int, int]:
        return tuple(max((abs(o[ax]) for o in self.offsets), default=0)
                     for ax in range(3))

    def min_dims(self) -> tuple[int, int, int]:
        return tuple(2 * l + 1 for l in self.L)

    def interior(self) -> dict:
        """offset -> interior coefficient."""
        return {o: float(self.table[o][self.L[0], self.L[1], self.L[2]])
                for o in self.offsets}

    def gershgorin(self) -> float:
        """Upper bound on λmax(D⁻¹A): max over class combos of
        Σ|c| / |diag| (rows of every class exist on a big enough grid)."""
        diag = np.abs(self.table[(0, 0, 0)])
        s = sum(np.abs(self.table[o]) for o in self.offsets)
        with np.errstate(divide="ignore", invalid="ignore"):
            q = np.where(diag > 0, s / np.maximum(diag, 1e-300), 0.0)
        return float(q.max())

    def _check_dims(self, dims) -> None:
        for d, m in zip(dims, self.min_dims()):
            if d < m:
                raise ValueError(
                    f"grid dims {tuple(dims)} below the classified "
                    f"stencil's minimum {self.min_dims()} (2L+1)")

    def _stencil_arg(self, dims):
        """[(offset, callable)] for galeri's stencil_csr / stencil_dia
        (their coefficient callables receive coordinate arrays)."""
        self._check_dims(dims)

        def make(o):
            tab = self.table[o]

            def coeff(ix, iy, iz=None):
                if iz is None:
                    iz = np.zeros_like(ix)
                return tab[_cls_index(ix, dims[0], self.L[0]),
                           _cls_index(iy, dims[1], self.L[1]),
                           _cls_index(iz, dims[2], self.L[2])]
            return coeff

        return [(o, make(o)) for o in self.offsets]

    def materialize_csr(self, dims, dtype=np.float64) -> CsrHost:
        return stencil_csr(tuple(dims), self._stencil_arg(dims),
                           dtype=dtype)

    def materialize_dia(self, dims, dtype, n_rows_pad=None, device=None):
        """The operator on grid ``dims`` as the port's ``DiaMatrix`` on
        ``device``."""
        return stencil_dia(tuple(dims), self._stencil_arg(dims),
                           dtype=dtype, n_rows_pad=n_rows_pad, device=device)

    def diag_vector(self, dims) -> np.ndarray:
        self._check_dims(dims)
        n = int(np.prod(dims))
        idx = np.arange(n)
        ix = idx % dims[0]
        iy = (idx // dims[0]) % dims[1]
        iz = idx // (dims[0] * dims[1])
        return self.table[(0, 0, 0)][
            _cls_index(ix, dims[0], self.L[0]),
            _cls_index(iy, dims[1], self.L[1]),
            _cls_index(iz, dims[2], self.L[2])]

    def compact(self, rtol: float = 1e-11) -> "ClassifiedStencil":
        """Shrink each axis' layer depth to the minimal L whose clamped
        classes reproduce the table (the probe guess is deliberately
        generous; smaller L → smaller grids stay materializable)."""
        L = list(self.L)
        table = self.table
        for ax in range(3):
            while L[ax] > 0:
                lo, hi, n_cls = L[ax] - 1, L[ax] + 1, 2 * L[ax] + 1
                ok = True
                for t in table.values():
                    sl_lo = np.take(t, lo, axis=ax)
                    sl_mid = np.take(t, L[ax], axis=ax)
                    sl_hi = np.take(t, hi, axis=ax)
                    scale = np.abs(sl_mid).max() + 1e-300
                    if (np.abs(sl_lo - sl_mid).max() > rtol * scale or
                            np.abs(sl_hi - sl_mid).max() > rtol * scale):
                        ok = False
                        break
                if not ok:
                    break
                # merge classes L-1, L, L+1 into the new interior
                keep = [i for i in range(n_cls) if i not in (lo, hi)]
                table = {o: np.take(t, keep, axis=ax)
                         for o, t in table.items()}
                L[ax] -= 1
        return ClassifiedStencil(offsets=self.offsets, L=tuple(L),
                                 table=table)

    def drop_lump(self, tol: float) -> "ClassifiedStencil":
        """Sparsified Galerkin: drop whole offsets whose magnitude never
        exceeds tol·|interior diag| and lump each class row's dropped
        values into its diagonal (row sums and symmetry preserved)."""
        if tol <= 0:
            return self
        dmag = abs(self.interior()[(0, 0, 0)])
        drop = [o for o in self.offsets
                if o != (0, 0, 0)
                and float(np.abs(self.table[o]).max()) <= tol * dmag]
        if not drop:
            return self
        lump = sum(self.table[o] for o in drop)
        table = {o: t for o, t in self.table.items() if o not in drop}
        table[(0, 0, 0)] = table[(0, 0, 0)] + lump
        offsets = tuple(o for o in self.offsets if o not in drop)
        return ClassifiedStencil(offsets=offsets, L=self.L, table=table)


def _block_tentative(probe_dims, block) -> CsrHost:
    """Block-constant tentative prolongator on a probe grid (all
    aggregates are full blocks — dims are multiples of the block)."""
    n = int(np.prod(probe_dims))
    idx = np.arange(n, dtype=np.int64)
    agg = np.zeros(n, dtype=np.int64)
    stride_c = 1
    rest = idx
    for d, b in zip(probe_dims, block):
        agg = agg + (rest % d) // b * stride_c
        stride_c *= d // b
        rest = rest // d
    n_c = int(np.prod([d // b for d, b in zip(probe_dims, block)]))
    nrm = float(1.0 / np.sqrt(np.prod(block)))
    return CsrHost.from_coo(idx, agg, np.full(n, nrm), (n, n_c),
                            sum_duplicates=False)


def _galerkin_on_grid(rep: ClassifiedStencil, dims, block,
                      omega: float) -> CsrHost:
    """Direct PᵀAP on a concrete grid: A from the classified rep,
    P = (I − ω D⁻¹A) P_t. Used for probes and for verification."""
    a = rep.materialize_csr(dims)
    return ptap(a, smooth_prolongator(a, _block_tentative(dims, block),
                                      omega))


def _read_classified(a_c: CsrHost, pc_dims, L) -> ClassifiedStencil:
    """Read the class table off a probe-grid Galerkin matrix: one row
    per class combination (probe dims ≥ 2L+1 ⇒ every combo exists)."""
    def probe_coord(c, ax):
        if c < L[ax]:
            return c
        if c == L[ax]:
            return pc_dims[ax] // 2
        return pc_dims[ax] - 1 - (2 * L[ax] - c)

    table: dict = {}
    shape = tuple(2 * l + 1 for l in L)
    for cx in range(shape[0]):
        for cy in range(shape[1]):
            for cz in range(shape[2]):
                x = probe_coord(cx, 0)
                y = probe_coord(cy, 1)
                z = probe_coord(cz, 2)
                g = x + pc_dims[0] * (y + pc_dims[1] * z)
                lo, hi = a_c.row_ptr[g], a_c.row_ptr[g + 1]
                for col, val in zip(a_c.cols[lo:hi], a_c.vals[lo:hi]):
                    rest = int(col)
                    off = []
                    for ax, d in enumerate(pc_dims):
                        off.append(rest % d - (x, y, z)[ax])
                        rest //= d
                    off = tuple(off)
                    if off not in table:
                        table[off] = np.zeros(shape)
                    table[off][cx, cy, cz] = val
    offsets = tuple(sorted(table))
    return ClassifiedStencil(offsets=offsets, L=tuple(L), table=table)


def galerkin_classified(rep: ClassifiedStencil, block, damping: float,
                        drop_tol: float = 0.02):
    """Exact boundary-classified Galerkin coarsening.

    Returns ``(coarse_rep, omega)`` where ``omega = damping /
    gershgorin(rep)`` is the prolongator-smoothing weight (shared with
    the runtime transfers). The coarse table is extracted from a probe
    PᵀAP, verified against a second, larger probe, compacted to the
    minimal layer depth, then sparsified (drop + diagonal lump).
    """
    omega = damping / rep.gershgorin()
    r = rep.reach()
    L_f = rep.L
    for attempt in range(4):
        # guessed coarse layer depth per axis (verified below, so the
        # formula only needs to be an adequate starting point)
        L_g = tuple(
            0 if (r[ax] == 0 and L_f[ax] == 0) else
            -(-(L_f[ax] + 2 * r[ax]) // block[ax]) + r[ax] + 1 + attempt
            for ax in range(3))
        pc = tuple(max(2 * L_g[ax] + 3, 1) for ax in range(3))
        pf = tuple(p * b for p, b in zip(pc, block))
        if any(p < m for p, m in zip(pf, rep.min_dims())):
            pf = tuple(max(p, m) for p, m in zip(pf, rep.min_dims()))
            # keep divisibility by the block
            pf = tuple(-(-p // b) * b for p, b in zip(pf, block))
            pc = tuple(p // b for p, b in zip(pf, block))
        a_cp = _galerkin_on_grid(rep, pf, block, omega)
        cand = _read_classified(a_cp, pc, L_g)
        # verification probe: +2 coarse cells per coarsened axis — the
        # classified form is accepted only if it reproduces a direct
        # PᵀAP on a grid it has never seen
        pc2 = tuple(p + 2 if b > 1 or rep.L[ax] > 0 else p
                    for ax, (p, b) in enumerate(zip(pc, block)))
        pf2 = tuple(p * b for p, b in zip(pc2, block))
        a_v = _galerkin_on_grid(rep, pf2, block, omega)
        a_m = cand.materialize_csr(pc2)
        if _csr_close(a_v, a_m):
            coarse = cand.compact().drop_lump(drop_tol).compact()
            return coarse, omega
    raise ValueError("classified Galerkin extraction did not stabilize "
                     "(layer depth guess exhausted)")


def _csr_close(a: CsrHost, b: CsrHost, rtol: float = 1e-9) -> bool:
    if a.shape != b.shape:
        return False
    diff = spadd(a, b, 1.0, -1.0)
    err = float(np.abs(diff.vals).max()) if len(diff.vals) else 0.0
    scale = float(np.abs(a.vals).max()) + 1e-300
    return err <= rtol * scale
