"""Block relaxation with pluggable containers (Dense, TriDi, Banded,
SparseILU0, Database).

Counterpart of ``trilinos_tpu/precond/containers.py`` (the analogue of
Ifpack2::BlockRelaxation and its Container family,
Ifpack2_BlockRelaxation_decl.hpp, Ifpack2_Container_decl.hpp; contiguous
blocks as LinearPartitioner makes them). Each diagonal block of A is
approximated by the container's structure:

  * Dense — the whole block, inverted on the host;
  * TriDi — the block's tridiagonal entries. The reference solves them
    by a batched tridiagonal solve at each apply (O(block) work, 2·bs
    dependent steps); the port inverts each tridiagonal block on the host
    at ``compute()`` by the Thomas algorithm (no pivoting, the elimination
    the reference's solve does) and applies the inverses as one batched
    matmul, since on the card each dependent step would be a kernel launch;
  * Banded — the entries within ``banded: bandwidth`` of the diagonal, as
    the dense inverse of that banded block;
  * SparseILU0 — ILU(0) of the block-diagonal filter of A;
  * Database — Dense, with blocks equal within the patch tolerance sharing
    one inverse (Ifpack2::DatabaseSchwarz).

Every container but SparseILU0 applies as one batched (nb, bs, bs) ×
(nb, bs, k) matmul. The apply is damped block-Jacobi sweeps
x ← x + ω C⁻¹ (r − A x); A is packed with ``choose_format`` for the
residuals of sweeps past the first. ``device`` places the tensors
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

_SPECS = {
    "relaxation: container": Param("relaxation: container", "Dense",
                                   choices=("Dense", "TriDi", "Banded",
                                            "SparseILU0", "Database")),
    "partitioner: block size": Param("partitioner: block size", 4),
    "relaxation: sweeps": Param("relaxation: sweeps", 1),
    "relaxation: damping factor": Param("relaxation: damping factor", 1.0),
    "banded: bandwidth": Param("banded: bandwidth", 1),
    "database schwarz: patch tolerance": Param(
        "database schwarz: patch tolerance", 1e-12,
        doc="blocks equal entrywise within this tol share one inverse"),
    "dtype": Param("dtype", None),
}


def diagonal_blocks(a: CsrHost, bs: int, nb_pad: int) -> np.ndarray:
    """(nb_pad, bs, bs) diagonal blocks of A over contiguous row blocks:
    in-block entries, a zero diagonal entry replaced by 1, identity on the
    rows past n (the reference's per-row loop, vectorized)."""
    n = a.shape[0]
    dense = np.tile(np.eye(bs), (nb_pad, 1, 1))
    rows = a._rows()
    cols = a.cols.astype(np.int64)
    real = np.arange(n)
    dense[real // bs, real % bs, :] = 0.0
    keep = rows // bs == cols // bs
    dense[rows[keep] // bs, rows[keep] % bs, cols[keep] % bs] = a.vals[keep]
    diag = dense[real // bs, real % bs, real % bs]
    zero = real[diag == 0]
    dense[zero // bs, zero % bs, zero % bs] = 1.0
    return dense


def safe_inverse(blocks: np.ndarray) -> np.ndarray:
    """Inverse of each block; a singular block (|det| < 1e-300) is replaced
    by its diagonal (zeros by 1) first."""
    blocks = blocks.copy()
    bad = np.abs(np.linalg.det(blocks)) < 1e-300
    for ib in np.flatnonzero(bad):
        d = np.diag(blocks[ib])
        blocks[ib] = np.diag(np.where(d != 0, d, 1.0))
    return np.linalg.inv(blocks)


def tridiagonal_inverse(dl: np.ndarray, d: np.ndarray,
                        du: np.ndarray) -> np.ndarray:
    """(nb, bs, bs) inverses of batched tridiagonal blocks (sub-diagonal
    ``dl[:, 1:]``, diagonal ``d``, super-diagonal ``du[:, :-1]``): the
    Thomas elimination without pivoting applied to the identity's
    columns."""
    nb, bs = d.shape
    piv = np.empty_like(d)
    cp = np.zeros_like(d)
    y = np.zeros((nb, bs, bs))
    for i in range(bs):
        piv[:, i] = d[:, i] - (dl[:, i] * cp[:, i - 1] if i else 0.0)
        cp[:, i] = du[:, i] / piv[:, i]
        y[:, i] = -dl[:, i, None] * y[:, i - 1] if i else 0.0
        y[:, i, i] += 1.0
        y[:, i] /= piv[:, i, None]
    for i in range(bs - 2, -1, -1):
        y[:, i] -= cp[:, i, None] * y[:, i + 1]
    return y


class BlockRelaxation(Preconditioner):
    """Damped block Jacobi over contiguous blocks with one container."""

    def __init__(self, a, params=None, device=None):
        super().__init__(a, params)
        self.device = resolve_device(device)

    def _do_initialize(self) -> None:
        self.params.validate(_SPECS)
        if not isinstance(self.a, CsrHost):
            raise TypeError("BlockRelaxation expects a CsrHost matrix")

    def _tensor(self, arr, dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            self.device, torch_dtype(dtype))

    def _do_compute(self) -> None:
        p = self.params
        dtype = p["dtype"] or self.a.vals.dtype
        bs = int(p["partitioner: block size"])
        container = str(p["relaxation: container"])
        n = self.a.shape[0]
        nb = -(-n // bs)
        nb_pad = round_up(nb * bs, ROW_ALIGN) // bs
        self.block_size = bs
        self.n_pad = nb_pad * bs
        self.container = container
        self.sweeps = int(p["relaxation: sweeps"])
        self.omega = float(p["relaxation: damping factor"])
        self.a_dev = choose_format(self.a, dtype=dtype, device=self.device)
        if container == "SparseILU0":
            # ILU(0) of the block-diagonal filter: its fill stays inside the
            # blocks, so one factorization serves every container
            from .ilu import Ilu0

            rows = self.a._rows()
            cols = self.a.cols.astype(np.int64)
            keep = rows // bs == cols // bs
            filt = CsrHost.from_coo(rows[keep], cols[keep], self.a.vals[keep],
                                    self.a.shape)
            self.inner = Ilu0(filt, {"dtype": dtype},
                              device=self.device).compute()
            return
        dense = diagonal_blocks(self.a, bs, nb_pad)
        if container == "TriDi":
            d = np.einsum("bii->bi", dense).copy()
            dl = np.zeros((nb_pad, bs))
            du = np.zeros((nb_pad, bs))
            dl[:, 1:] = np.einsum("bii->bi", dense[:, 1:, :-1])
            du[:, :-1] = np.einsum("bii->bi", dense[:, :-1, 1:])
            self.inv_blocks = self._tensor(tridiagonal_inverse(dl, d, du),
                                           dtype)
        elif container == "Database":
            # identical patches (within the tolerance) share one inverse;
            # the apply gathers each block's inverse by its patch index
            ptol = float(p["database schwarz: patch tolerance"])
            q = np.round(dense / max(ptol, 1e-300)).astype(np.int64)
            _, first, idx = np.unique(q.reshape(nb_pad, -1), axis=0,
                                      return_index=True, return_inverse=True)
            self.n_patches = len(first)
            self.inv_unique = self._tensor(safe_inverse(dense[first]), dtype)
            self.patch_idx = torch.from_numpy(idx.reshape(-1)).to(self.device)
        else:
            if container == "Banded":
                i_idx = np.arange(bs)
                mask = np.abs(i_idx[:, None] - i_idx[None, :]) <= int(
                    p["banded: bandwidth"])
                dense = np.where(mask[None], dense, 0.0)
                dg = np.einsum("bii->bi", dense)
                np.einsum("bii->bi", dense)[...] = np.where(dg != 0, dg, 1)
            self.inv_blocks = self._tensor(safe_inverse(dense), dtype)

    def _container_solve(self, r2: torch.Tensor) -> torch.Tensor:
        """(npad_in, k) -> (npad_in, k): the per-block solves."""
        if self.container == "SparseILU0":
            return self.inner.apply(r2)
        bs, k = self.block_size, r2.shape[1]
        npad_in = r2.shape[0]
        x2 = r2
        if npad_in < self.n_pad:
            x2 = torch.nn.functional.pad(x2, (0, 0, 0, self.n_pad - npad_in))
        xb = x2[:self.n_pad].reshape(-1, bs, k)
        inv = (self.inv_unique[self.patch_idx]
               if self.container == "Database" else self.inv_blocks)
        yb = torch.bmm(inv, xb.to(inv.dtype))
        y = yb.reshape(-1, k)
        if y.shape[0] < npad_in:
            y = torch.nn.functional.pad(y, (0, 0, 0, npad_in - y.shape[0]))
        return y[:npad_in]

    def _apply(self, r: torch.Tensor) -> torch.Tensor:
        was_1d = r.ndim == 1
        r2 = r[:, None] if was_1d else r
        x = self.omega * self._container_solve(r2)
        for _ in range(self.sweeps - 1):
            x = x + self.omega * self._container_solve(
                r2 - spmv(self.a_dev, x))
        return x[:, 0] if was_1d else x
