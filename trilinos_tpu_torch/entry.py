"""The port's main paths: the twin of ``__graft_entry__.entry()`` and the
block solve.

``entry()``: structured-AMG-preconditioned CG on a matrix-free Galeri
Laplace3D stencil. It builds the operator, the hierarchy and the
right-hand side (same defaults and seed as the JAX package's entry: 16³,
float32, ``default_rng(0)``) and returns ``(step, (b, state))``;
``step(b, state)`` runs the solve and returns the :class:`SolveResult`
(the JAX step returns its ``.x``).

``block_entry()``: the same operator and hierarchy under block GMRES with
CGS2 projection and CholQR2 normalisation, nrhs right-hand sides
(BASELINE config 5: "Block-GMRES nrhs=16 with CGS2 ortho on a 10M-row
stencil matrix"). Both take an already-built ``SaAmg`` as ``amg=`` so one
hierarchy can serve both paths; grid, dtype and device then come from it.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .galeri import laplace3d
from .ops.matvec import spmv
from .precond import SaAmg
from .solvers import block_gmres, cg


def _hierarchy(dims, dtype, device, amg):
    """(operator, SaAmg) of Laplace3D on ``dims``, or those of ``amg``."""
    if amg is None:
        op = laplace3d(*dims, dtype=dtype, fmt="stencil")
        amg = SaAmg(op, {"dtype": dtype},
                    device=resolve_device(device)).compute()
    return amg.fine_op, amg


def _rhs(op, amg, nrhs=None):
    """Seed-0 normal right-hand side(s) on the hierarchy's device and dtype,
    zero in the pad rows."""
    n, npad = op.n_rows, op.n_rows_pad
    tail = () if nrhs is None else (nrhs,)
    host = np.zeros((npad,) + tail, np.float64)
    host[:n] = np.random.default_rng(0).standard_normal((n,) + tail)
    return torch.from_numpy(host).to(amg.device, amg.dtype)


def entry(dims=(16, 16, 16), dtype=np.float32, device=None, amg=None):
    op, m = _hierarchy(dims, dtype, device, amg)

    def step(b_vec: torch.Tensor, st: dict):
        return cg(lambda v: spmv(op, v), b_vec,
                  prec=lambda v: m.apply_state(st, v),
                  rtol=1e-5, maxiter=50)

    return step, (_rhs(op, m), m.state())


def block_entry(dims=(16, 16, 16), nrhs=16, dtype=np.float32, device=None,
                amg=None):
    op, m = _hierarchy(dims, dtype, device, amg)

    def step(b_mv: torch.Tensor, st: dict):
        return block_gmres(lambda v: spmv(op, v), b_mv,
                           prec=lambda v: m.apply_state(st, v),
                           num_blocks=25, max_restarts=10, rtol=1e-5,
                           ortho="CGS2")

    return step, (_rhs(op, m, nrhs), m.state())
