"""Additive Schwarz domain-decomposition preconditioner.

Counterpart of ``trilinos_tpu/precond/schwarz.py`` (the analogue of
Ifpack2::AdditiveSchwarz, Ifpack2_AdditiveSchwarz_decl.hpp): subdomains are
contiguous row chunks (or the parts of "schwarz: subdomain ids") grown by
``overlap`` rounds of distance-1 graph expansion on the host, padded to one
size and inverted densely, so the apply is one batched matmul over the
subdomains, a weighting and a scatter-add. Combine modes: "add" (classic
AS) and "restricted" (RAS: each row kept from its owning subdomain only).
Pad slots gather row 0 and carry weight 0. The scatter-add is
``index_add_``, whose CUDA atomics sum overlapping contributions in no
fixed order, so in "add" mode two runs agree to rounding, not to the bit.
``device`` places the tensors (``None``: the CUDA card).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device, torch_dtype
from ..ops.formats import CsrHost, round_up
from ..utils.params import Param
from .base import Preconditioner

_SPECS = {
    "schwarz: num subdomains": Param("schwarz: num subdomains", 4),
    "schwarz: overlap level": Param("schwarz: overlap level", 1),
    "schwarz: combine mode": Param("schwarz: combine mode", "restricted",
                                   choices=("add", "restricted")),
    "schwarz: subdomain ids": Param(
        "schwarz: subdomain ids", None,
        doc="optional length-n part array from parallel.partition; "
            "default is contiguous chunks"),
    "dtype": Param("dtype", None),
}


class AdditiveSchwarz(Preconditioner):
    """Overlapping Schwarz with a dense inverse per subdomain."""

    def __init__(self, a, params=None, device=None):
        super().__init__(a, params)
        self.device = resolve_device(device)

    def _do_initialize(self) -> None:
        self.params.validate(_SPECS)
        if not isinstance(self.a, CsrHost):
            raise TypeError("AdditiveSchwarz expects a CsrHost matrix")

    def _do_compute(self) -> None:
        p = self.params
        nd = int(p["schwarz: num subdomains"])
        overlap = int(p["schwarz: overlap level"])
        dtype = p["dtype"] or self.a.vals.dtype
        n = self.a.shape[0]
        subsets = []
        if p["schwarz: subdomain ids"] is not None:
            owners = np.asarray(p["schwarz: subdomain ids"], dtype=np.int64)
            if owners.shape != (n,) or owners.max() >= nd:
                raise ValueError("subdomain ids must be length n with "
                                 "ids < num subdomains")
        else:
            chunk = -(-n // nd)
            owners = np.minimum(np.arange(n) // chunk, nd - 1)
        self.owners = owners  # the non-overlapping partition, row → part
        for d in range(nd):
            sel = np.where(owners == d)[0]
            cur = set(sel.tolist())
            for _ in range(overlap):
                grow = set()
                for i in list(cur):
                    cols, _ = self.a.row(i)
                    grow.update(int(c) for c in cols)
                cur |= grow
            subsets.append(np.array(sorted(cur), dtype=np.int64))
        smax = round_up(max(len(s) for s in subsets), 8)
        inv = np.zeros((nd, smax, smax))
        gather = np.zeros((nd, smax), dtype=np.int64)
        weight = np.zeros((nd, smax))
        for d, sub in enumerate(subsets):
            k = len(sub)
            loc = np.eye(smax)
            index = {int(g): j for j, g in enumerate(sub)}
            for j, i in enumerate(sub):
                cols, vals = self.a.row(int(i))
                loc[j, :k] = 0
                for c, v in zip(cols, vals):
                    jj = index.get(int(c))
                    if jj is not None:
                        loc[j, jj] = v
                if loc[j, j] == 0:
                    loc[j, j] = 1.0
            inv[d] = np.linalg.inv(loc)
            gather[d, :k] = sub
            if p["schwarz: combine mode"] == "restricted":
                weight[d, :k] = (owners[sub] == d).astype(float)
            else:
                weight[d, :k] = 1.0
        self.set_state(torch.from_numpy(inv).to(self.device,
                                                torch_dtype(dtype)),
                       torch.from_numpy(gather).to(self.device),
                       torch.from_numpy(weight).to(self.device,
                                                   torch_dtype(dtype)))

    def set_state(self, inv: torch.Tensor, gather: torch.Tensor,
                  weight: torch.Tensor) -> None:
        """Take the (nd, smax, smax) subdomain inverses, the (nd, smax) rows
        each subdomain gathers (pad slots gather row 0) and their combine
        weights (0 on pad slots) as they are (``convert.schwarz_from_numpy``
        carries the JAX package's in)."""
        self.inv, self.gather, self.weight = inv, gather, weight
        self._computed = True

    def _apply(self, r: torch.Tensor) -> torch.Tensor:
        was_1d = r.ndim == 1
        r2 = r[:, None] if was_1d else r
        k = r2.shape[1]
        local = r2[self.gather].to(self.inv.dtype)  # (nd, smax, k)
        sol = torch.bmm(self.inv, local) * self.weight[:, :, None]
        y = torch.zeros_like(r2)
        y.index_add_(0, self.gather.reshape(-1),
                     sol.reshape(-1, k).to(r2.dtype))
        return y[:, 0] if was_1d else y
