"""Dense LU solves (the Pliris analogue).

Counterpart of ``trilinos_tpu/solvers/pliris.py``. On one device the
reference's dense solve is the library LU (``jnp.linalg.solve``, outside
any Pallas kernel), so the port's is ``torch.linalg.solve`` on the
tensors' device.

``dist_dense_solve`` is the JAX package's column-block LU with partial
pivoting, run in every rank of a group: rank r holds columns
[r·c, (r + 1)·c) of the matrix, c = n / P, so a row swap is a local move
on every rank and a panel never crosses ranks. For each panel of ``nb``
columns, its owner factors the (m × nb) panel (``torch.linalg.lu_factor``)
and broadcasts the factor and the row permutation; every rank permutes
its trailing rows and the replicated right-hand side, solves its U12
strip and applies the rank-nb update to its columns right of the panel.
The forward substitution rides the factor loop (the broadcast panel is
reused); the backward pass takes one (nb, k) sum over the group a panel,
and rank 0's x is broadcast, so that every rank holds the same bits.
The JAX package computes masked updates on every shard to keep its shapes
static; here each rank updates only its own trailing columns, the same
arithmetic.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..parallel.comm import Comm


def dense_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with a @ x = b for a square ``a`` and b of shape (n,) or (n, k),
    on the tensors' device (Pliris on one rank: LU with partial
    pivoting)."""
    return torch.linalg.solve(a, b)


def _row_perm(pivots: torch.Tensor, m: int) -> torch.Tensor:
    """LAPACK's one-based sequential row swaps of an (m × nb) panel as the
    permutation vector ``perm`` with panel[perm] = L·U (the JAX package's
    ``lax.linalg.lu`` convention)."""
    perm = list(range(m))
    for i, p in enumerate(pivots.tolist()):
        perm[i], perm[p - 1] = perm[p - 1], perm[i]
    return torch.tensor(perm, dtype=torch.int64, device=pivots.device)


def dist_dense_solve(comm: Comm, a, b, nb: int = 128, device=None):
    """Solve a @ x = b with the column-block LU with partial pivoting over
    ``comm``'s ranks; call it in every rank. ``a`` is the (n, n) matrix
    (every rank passes it and keeps its own columns) and ``b`` (n,) or
    (n, k). A tensor ``a`` stays on its device; of a numpy one the rank's
    columns go to ``device`` (``None``: the card); ``b`` follows. Returns x
    with b's trailing shape, the same on every rank.

    ``nb``: panel width, clipped to the columns a rank holds (it must
    divide them)."""
    p, me = comm.size, comm.index()
    n = a.shape[0]
    if tuple(a.shape) != (n, n):
        raise ValueError("a must be square")
    if n % p:
        raise ValueError(f"n={n} not divisible by group size {p}")
    c = n // p
    nb = min(nb, c)
    if c % nb:
        raise ValueError(f"panel width {nb} must divide columns/rank {c}")
    mine = slice(me * c, (me + 1) * c)  # my global columns
    if isinstance(a, torch.Tensor):
        a_loc = a[:, mine].clone()
    else:
        a_loc = torch.from_numpy(np.array(a[:, mine])).to(
            resolve_device(device))
    b = torch.as_tensor(b).to(a_loc.device)
    was_1d = b.ndim == 1
    y = (b[:, None] if was_1d else b).to(a_loc.dtype).clone()

    u_diags = []
    for pan in range(n // nb):
        r0 = pan * nb  # panel top row and column
        owner = r0 // c
        m = n - r0
        if me == owner:
            lc = r0 - owner * c
            lu, piv = torch.linalg.lu_factor(a_loc[r0:, lc:lc + nb])
            perm = _row_perm(piv, m)
        else:
            lu = a_loc.new_empty((m, nb))
            perm = torch.empty(m, dtype=torch.int64, device=a_loc.device)
        lu = comm.broadcast(lu, owner)
        perm = comm.broadcast(perm, owner)

        # the row permutation of rows ≥ r0, local on every rank
        a_loc[r0:] = a_loc[r0:][perm]
        y[r0:] = y[r0:][perm]
        l11 = torch.tril(lu[:nb], -1) + torch.eye(nb, dtype=lu.dtype,
                                                  device=lu.device)
        l21 = lu[nb:]
        u_diags.append(torch.triu(lu[:nb]))
        if me == owner:
            # the owner's panel columns take the factor (rows above r0 hold
            # earlier U12 strips)
            a_loc[r0:, lc:lc + nb] = lu

        # U12 strip and rank-nb trailing update on my columns right of the
        # panel
        t0 = min(max(r0 + nb - me * c, 0), c)
        if t0 < c:
            u12 = torch.linalg.solve_triangular(
                l11, a_loc[r0:r0 + nb, t0:], upper=False, unitriangular=True)
            a_loc[r0:r0 + nb, t0:] = u12
            if m > nb:
                a_loc[r0 + nb:, t0:] -= l21 @ u12

        # forward substitution on the replicated right-hand side
        y2 = torch.linalg.solve_triangular(l11, y[r0:r0 + nb], upper=False,
                                           unitriangular=True)
        y[r0:r0 + nb] = y2
        if m > nb:
            y[r0 + nb:] -= l21 @ y2

    # backward substitution: x_p = U11⁻¹ (y_p − Σ_{q>p} U_pq x_q)
    x = torch.zeros_like(y)
    for pan in reversed(range(n // nb)):
        r0 = pan * nb
        t0 = min(max(r0 + nb - me * c, 0), c)  # my columns with known x
        part = a_loc[r0:r0 + nb, t0:] @ x[me * c + t0:(me + 1) * c]
        rhs = y[r0:r0 + nb] - comm.psum(part)
        x[r0:r0 + nb] = torch.linalg.solve_triangular(u_diags[pan], rhs,
                                                      upper=True)
    # every rank computed x from the same values, but a BLAS call may round
    # differently with its buffers' alignment: rank 0's x, on every rank
    x = comm.broadcast(x, 0)
    return x[:, 0] if was_1d else x
