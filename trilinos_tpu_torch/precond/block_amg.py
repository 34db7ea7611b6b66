"""Block-structured null-space AMG for elasticity: BDIA levels.

Counterpart of ``trilinos_tpu/precond/block_amg.py`` (MueLu SA on
elasticity: TentativePFactory with rigid-body modes, AmalgamationFactory,
TripleMatrixMultiply) for PDE systems whose nodes lie on a structured grid
(``galeri.fem.elasticity2d``/``elasticity3d``):

  * node aggregation is structured 2×2×2 blocks, so the tentative
    prolongator's per-aggregate QR blocks form one (n_pos, n_agg, b, k)
    tensor, and its apply is a strided view of the fine grid and an
    elementwise (b, k) contraction, with no gathers;
  * smoothed transfers cost one operator apply each
    (P = (I − ωD⁻¹A)P_t ⇒ Pᵀr = P_tᵀ(r − ωA(D⁻¹r)), A symmetric);
  * every level is the exact host Galerkin operator PᵀAP of the smoothed P
    (the native SpGEMM), stored as a :class:`BdiaMatrix`, whose applies are
    the BDIA kernel on the card;
  * coarse levels carry k dofs per aggregate (k = null-space dimension: 3
    in 2-D, 6 in 3-D) and recurse with the coarse null space, ending in a
    dense pseudo-inverse.

Set-up is host numpy; the level operators, Jacobi diagonals, tentative
blocks and coarse inverse live on ``device``.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from ..device import resolve_device, torch_dtype
from ..ops.formats import CsrHost, ROW_ALIGN, csr_to_bdia, round_up
from ..ops.matrix_ops import ptap
from ..ops.matvec import spmv
from ..utils.params import Param
from .amg import structured_block
from .amg import smooth_prolongator, tentative_prolongator_nullspace
from .base import Preconditioner

_SPECS = {
    "max levels": Param("max levels", 10),
    "coarse: max size": Param("coarse: max size", 512),
    "sa: damping factor": Param("sa: damping factor", 4.0 / 3.0),
    "smoother: sweeps": Param("smoother: sweeps", 2),
    "smoother: damping factor": Param("smoother: damping factor", 0.8),
    "cycle type": Param("cycle type", "V", choices=("V", "W")),
    "dtype": Param("dtype", None),
}


def _structured_node_agg(dims, block) -> np.ndarray:
    """Aggregate id per node, x-fastest like node gids."""
    n = int(np.prod(dims))
    idx = np.arange(n, dtype=np.int64)
    agg = np.zeros(n, dtype=np.int64)
    stride = 1
    rest = idx
    for d, bb in zip(dims, block):
        agg = agg + (rest % d) // bb * stride
        stride *= d // bb
        rest = rest // d
    return agg


def _positions(block):
    """Aggregate-local node positions (px, py, pz), x fastest."""
    return [p[::-1] for p in itertools.product(
        range(block[2]), range(block[1]), range(block[0]))]


def _extract_q(p_t: CsrHost, dims, block, b: int, k: int) -> np.ndarray:
    """Per-position tentative blocks Q[(pz,py,px)] as one
    (n_pos, n_agg, b, k) tensor, read off the CSR P_t (every dof row holds
    exactly its aggregate's k sorted columns)."""
    n_dofs = p_t.shape[0]
    if int(p_t.row_ptr[-1]) != n_dofs * k:
        raise ValueError("tentative prolongator rows must hold k entries")
    qflat = np.asarray(p_t.vals, dtype=np.float64).reshape(n_dofs, k)
    nx, ny, _ = dims
    cdims = tuple(d // bb for d, bb in zip(dims, block))
    n_agg = int(np.prod(cdims))
    pos = _positions(block)
    q = np.zeros((len(pos), n_agg, b, k))
    cidx = np.arange(n_agg, dtype=np.int64)
    cx = cidx % cdims[0]
    cy = (cidx // cdims[0]) % cdims[1]
    cz = cidx // (cdims[0] * cdims[1])
    for pi, (px, py, pz) in enumerate(pos):
        node = ((block[0] * cx + px)
                + nx * ((block[1] * cy + py) + ny * (block[2] * cz + pz)))
        for i in range(b):
            q[pi, :, i, :] = qflat[b * node + i]
    return q


def _gershgorin_dinv_a(a: CsrHost) -> float:
    """Gershgorin bound of λmax(D⁻¹A): max over rows of Σ|a_ij| / |a_ii|."""
    d = np.abs(a.diagonal())
    s = np.zeros(a.shape[0])
    np.add.at(s, a._rows(), np.abs(a.vals))
    with np.errstate(divide="ignore"):
        return float(np.max(s / np.maximum(d, 1e-300)))


def _block_ns_transfers(a_dev, dims, block, b: int, k: int, q_dev,
                        omega: float, dinv, npad_f: int, npad_c: int):
    """Smoothed transfers of one block-structured level, without gathers.

    The fine grid (nz, ny, nx, b) is viewed as (cz, bz, cy, by, cx, bx, b):
    position (px, py, pz) of every aggregate is the strided slice
    [:, pz, :, py, :, px] of that view, and ``q_dev[pi]`` holds its
    (b, k) tentative blocks. The positions are disjoint, so the tentative
    apply writes each fine node once, as the JAX package's dilation pads
    sum it with zeros.
    """
    nx, ny, nz = dims
    bx, by, bz = block
    cx, cy, cz = (d // bb for d, bb in zip(dims, block))
    n_f = nx * ny * nz * b
    n_c = cx * cy * cz * k
    n_pos = bx * by * bz
    # (bz, by, bx, cz, cy, cx, b, k): the positions in _positions order
    q7 = q_dev.reshape(bz, by, bx, cz, cy, cx, b, k)

    def _pad(v, npad):
        out = v.new_zeros(npad)
        out[:v.shape[0]] = v
        return out

    def tentative(e):
        e4 = e[:n_c].reshape(cz, cy, cx, 1, k)
        blk = (q7 * e4).sum(-1)  # (bz, by, bx, cz, cy, cx, b)
        fine = blk.permute(3, 0, 4, 1, 5, 2, 6)  # (cz, bz, cy, by, cx, bx, b)
        return _pad(fine.reshape(-1), npad_f)

    def tentative_t(r):
        r7 = r[:n_f].reshape(cz, bz, cy, by, cx, bx, b)
        rp = r7.permute(1, 3, 5, 0, 2, 4, 6)[..., None]  # positions first
        e = (q7 * rp).sum(-2).reshape(n_pos, cz, cy, cx, k).sum(0)
        return _pad(e.reshape(-1), npad_c)

    def dmul(v):
        return dinv * v

    def restrict(r):
        return tentative_t(r - omega * spmv(a_dev, dmul(r)))

    def prolong(e):
        t = tentative(e)
        return t - omega * dmul(spmv(a_dev, t))

    return restrict, prolong


class BlockStructuredAmg(Preconditioner):
    """Null-space SA with structured node aggregation and BDIA levels.

    ``BlockStructuredAmg(a, {...}, node_dims=(nx, ny, nz), nullspace=ns,
    n_equations=b, device=None)``: ``a`` is the interleaved-dof CsrHost
    (``galeri.fem`` layout), ``ns`` the (n_dofs, k) modes
    (``galeri.fem.rigid_body_modes``). ``device`` places the hierarchy's
    tensors: ``None`` means the CUDA card (raises without one), tests pass
    ``"cpu"``. ``fine_op`` is the fine operator as a BdiaMatrix on that
    device (level 0's, so that one copy serves the solver and the cycle).
    """

    def __init__(self, a, params=None, *, node_dims, nullspace,
                 n_equations: int, device=None):
        super().__init__(a, params)
        self.node_dims = tuple(node_dims) + (1,) * (3 - len(node_dims))
        self.nullspace = np.asarray(nullspace, dtype=np.float64)
        self.b = int(n_equations)
        self.device = resolve_device(device)

    def _do_initialize(self) -> None:
        self.params.validate(_SPECS)
        if not isinstance(self.a, CsrHost):
            raise TypeError("BlockStructuredAmg expects a CsrHost matrix")
        if self.a.shape[0] != int(np.prod(self.node_dims)) * self.b:
            raise ValueError("node_dims × n_equations != matrix size")
        if self.nullspace.shape[0] != self.a.shape[0]:
            raise ValueError("nullspace rows != matrix size")
        if all(bb == 1 for bb in structured_block(self.node_dims)):
            raise ValueError("node grid has no even axis >= 4 to "
                             "aggregate (use SaAmg's uncoupled path)")

    def _do_compute(self) -> None:
        p = self.params
        dtype = torch_dtype(p["dtype"] or self.a.vals.dtype)
        damping = float(p["sa: damping factor"])
        self.sweeps = int(p["smoother: sweeps"])
        self.omega = float(p["smoother: damping factor"])
        self.gamma = 2 if p["cycle type"] == "W" else 1
        self.dtype = dtype
        coarse_max = int(p["coarse: max size"])

        a, ns, dims, b = self.a, self.nullspace, self.node_dims, self.b
        k = ns.shape[1]
        self.levels = []
        for _ in range(int(p["max levels"]) - 1):
            block = structured_block(dims)
            if a.shape[0] <= coarse_max or all(bb == 1 for bb in block):
                break
            agg = _structured_node_agg(dims, block)
            p_t, ns_c = tentative_prolongator_nullspace(agg, b, ns)
            q = _extract_q(p_t, dims, block, b, k)
            # ONE omega shared by the host Galerkin P and the device
            # transfer applies, so the coarse operator is the exact PᵀAP
            # of the prolongator the cycle applies
            gersh = _gershgorin_dinv_a(a)
            omega_t = damping / gersh
            p_s = smooth_prolongator(a, p_t, omega_t)
            a_c = ptap(a, p_s)

            cdims = tuple(d // bb for d, bb in zip(dims, block))
            a_dev = csr_to_bdia(a, b, dtype=dtype, device=self.device)
            npad_f = a_dev.n_rows_pad
            # the next level's BDIA padding: round_up(block rows) · k rows
            npad_c = round_up(int(np.prod(cdims)), ROW_ALIGN) * k
            d = a.diagonal()
            dv = np.ones(npad_f)
            dv[: a.shape[0]] = 1.0 / np.where(d != 0, d, 1.0)
            dinv = torch.from_numpy(dv).to(self.device, dtype)
            q_dev = torch.from_numpy(q).to(self.device, dtype)
            restrict, prolong = _block_ns_transfers(
                a_dev, dims, block, b, k, q_dev, omega_t, dinv, npad_f,
                npad_c)
            self.levels.append(dict(
                a=a_dev, dinv=dinv, restrict=restrict, prolong=prolong,
                q=q_dev, bk=(b, k), omega_t=omega_t,
                # damped-Jacobi weight scaled to the level's spectrum: the
                # user damping (0.8) is set for λmax(D⁻¹A) = 2 (Laplacians);
                # elasticity reaches 2.6 and more, and a smoother with
                # ω·λmax > 2 makes the cycle indefinite; rounded once to the
                # diagonal's type, as JAX treats a Python scalar (it matters
                # for bf16 diagonals)
                omega_s=torch.tensor(self.omega * 2.0 / gersh,
                                     dtype=dtype).item(),
                n_f=npad_f, n_c=npad_c, dims=dims, block=block))
            a, ns, dims, b = a_c, ns_c, cdims, k
        if self.levels:
            self.fine_op = self.levels[0]["a"]
            npad = self.levels[-1]["n_c"]
        else:
            # no level: the pseudo-inverse of the whole matrix, padded as
            # its BDIA form (the same rows as round_up(n) when b | 8)
            self.fine_op = csr_to_bdia(a, b, dtype=dtype, device=self.device)
            npad = self.fine_op.n_rows_pad
        nc = a.shape[0]
        dense = np.eye(npad)
        dense[:nc, :nc] = a.to_dense()
        self.coarse_inv = torch.from_numpy(
            np.linalg.pinv(dense, rcond=1e-12)).to(self.device, dtype)

    def n_levels(self) -> int:
        return len(self.levels) + 1

    def state(self) -> dict:
        """The hierarchy's tensors as a plain dict, applied with
        :meth:`apply_state`; ``convert.block_amg_state_from_jax`` builds one
        from the JAX package's ``BlockStructuredAmg.state()``."""
        return {"levels": [{"a": lv["a"], "dinv": lv["dinv"], "q": lv["q"]}
                           for lv in self.levels],
                "coarse_inv": self.coarse_inv}

    def apply_state(self, st: dict, r: torch.Tensor) -> torch.Tensor:
        """Cycle reading the level operators, Jacobi diagonals, tentative
        blocks and coarse inverse from ``st``; grid shapes and weights come
        from ``self``."""
        levels = []
        for lvl, s in zip(self.levels, st["levels"], strict=True):
            bb, kk = lvl["bk"]
            restrict, prolong = _block_ns_transfers(
                s["a"], lvl["dims"], lvl["block"], bb, kk, s["q"],
                lvl["omega_t"], s["dinv"], lvl["n_f"], lvl["n_c"])
            levels.append(dict(lvl, a=s["a"], dinv=s["dinv"],
                               restrict=restrict, prolong=prolong))
        return self._cycle(levels, st["coarse_inv"], 0, r)

    def _smooth(self, lvl, x, r):
        w = lvl["omega_s"]
        for _ in range(self.sweeps):
            x = x + w * lvl["dinv"] * (r - spmv(lvl["a"], x))
        return x

    def _cycle(self, levels, coarse_inv, k: int,
               r: torch.Tensor) -> torch.Tensor:
        if k == len(levels):
            return coarse_inv.to(r.dtype) @ r
        lvl = levels[k]
        x = self._smooth(lvl, torch.zeros_like(r), r)
        # gamma=1: V-cycle; gamma=2: W-cycle
        for _ in range(self.gamma):
            res = r - spmv(lvl["a"], x)
            x = x + lvl["prolong"](self._cycle(
                levels, coarse_inv, k + 1, lvl["restrict"](res)))
        return self._smooth(lvl, x, r)

    def _apply(self, r: torch.Tensor) -> torch.Tensor:
        if r.ndim != 1:
            raise NotImplementedError(
                "BlockStructuredAmg: single-vector apply only")
        return self.apply_state(self.state(), r)
