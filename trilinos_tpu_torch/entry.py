"""The port's main path: the twin of ``__graft_entry__.entry()``.

Structured-AMG-preconditioned CG on a matrix-free Galeri Laplace3D
stencil. ``entry()`` builds the operator, the hierarchy and the right-hand
side (same defaults and seed as the JAX package's entry: 16³, float32,
``default_rng(0)``) and returns ``(step, (b, state))``; ``step(b, state)``
runs the solve and returns the :class:`SolveResult` (the JAX step returns
its ``.x``).
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .galeri import laplace3d
from .ops.matvec import spmv
from .precond import SaAmg
from .solvers import cg


def entry(dims=(16, 16, 16), dtype=np.float32, device=None):
    device = resolve_device(device)
    op = laplace3d(*dims, dtype=dtype, fmt="stencil")
    m = SaAmg(op, {"dtype": dtype}, device=device).compute()
    n, npad = op.n_rows, op.n_rows_pad
    b = np.zeros(npad, dtype)
    b[:n] = np.random.default_rng(0).standard_normal(n)

    def step(b_vec: torch.Tensor, st: dict):
        return cg(lambda v: spmv(op, v), b_vec,
                  prec=lambda v: m.apply_state(st, v),
                  rtol=1e-5, maxiter=50)

    return step, (torch.from_numpy(b).to(device), m.state())
