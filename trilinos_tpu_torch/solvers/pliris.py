"""Dense LU solve (the Pliris analogue).

Counterpart of ``trilinos_tpu/solvers/pliris.py``. On one device the
reference's dense solve is the library LU (``jnp.linalg.solve``, outside
any Pallas kernel), so the port's is ``torch.linalg.solve`` on the
tensors' device. The distributed column-block LU, ``dist_dense_solve``,
needs the distributed layer.
"""
from __future__ import annotations

import torch


def dense_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with a @ x = b for a square ``a`` and b of shape (n,) or (n, k),
    on the tensors' device (Pliris on one rank: LU with partial
    pivoting)."""
    return torch.linalg.solve(a, b)


def dist_dense_solve(*args, **kwargs):
    """The column-block-sharded LU over a device mesh: not ported yet."""
    raise NotImplementedError(
        "dist_dense_solve needs the distributed layer, not ported yet "
        "(ROADMAP.md queue 1 item 10)")
