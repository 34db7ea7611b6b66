"""The port's paths on the Galeri Laplace3D stencil.

``entry()``: structured-AMG-preconditioned CG on a matrix-free Galeri
Laplace3D stencil, the twin of ``__graft_entry__.entry()``. It builds the
operator, the hierarchy and the right-hand side (same defaults and seed as
the JAX package's entry: 16³, float32, ``default_rng(0)``) and returns
``(step, (b, state))``; ``step(b, state)`` runs the solve and returns the
:class:`SolveResult` (the JAX step returns its ``.x``).

``block_entry()``: the same operator and hierarchy under block GMRES with
CGS2 projection and CholQR2 normalisation, nrhs right-hand sides
(BASELINE config 5: "Block-GMRES nrhs=16 with CGS2 ortho on a 10M-row
stencil matrix").

``cheb_entry()``: AMG-PCG as ``entry()`` with the Chebyshev smoother on
the fine level (degree sweeps+1 = 3, one stencil polynomial apply).

``sstep_entry()``: unpreconditioned s-step GMRES with the matrix-powers
basis, the JAX package's bench configuration (s = 4, t_blocks = 8,
max_restarts = 4, rtol = 0, σ = 12: five cycles of 32 basis vectors);
``step(b)``.

``fused_cg_entry()``: unpreconditioned CG with one fused iteration kernel
per iteration (rtol 1e-5, maxiter 2000 by default); ``step(b)``.

Every entry takes ``device`` (``None`` means the CUDA card and raises
without one); the hierarchy paths also take an already-built ``SaAmg`` as
``amg=`` so one hierarchy can serve several paths, and their grid, dtype
and device then come from it. Right-hand sides are seed-0 normals with
zero pad rows.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device, torch_dtype
from .galeri import laplace3d
from .ops.matvec import spmv
from .precond import SaAmg
from .solvers import block_gmres, cg, cg_fused, sstep_gmres


def _hierarchy(dims, dtype, device, amg, smoother="jacobi"):
    """(operator, SaAmg) of Laplace3D on ``dims``, or those of ``amg``."""
    if amg is None:
        op = laplace3d(*dims, dtype=dtype, fmt="stencil")
        amg = SaAmg(op, {"dtype": dtype, "smoother: type": smoother},
                    device=resolve_device(device)).compute()
    elif amg.params["smoother: type"] != smoother:
        raise ValueError(f"this path needs a hierarchy with the {smoother} "
                         f"smoother, got {amg.params['smoother: type']}")
    return amg.fine_op, amg


def _rhs(op, device, dtype, nrhs=None):
    """Seed-0 normal right-hand side(s) on ``device`` in ``dtype``, zero in
    the pad rows."""
    n, npad = op.n_rows, op.n_rows_pad
    tail = () if nrhs is None else (nrhs,)
    host = np.zeros((npad,) + tail, np.float64)
    host[:n] = np.random.default_rng(0).standard_normal((n,) + tail)
    return torch.from_numpy(host).to(device, dtype)


def _amg_cg(op, m):
    def step(b_vec: torch.Tensor, st: dict):
        return cg(lambda v: spmv(op, v), b_vec,
                  prec=lambda v: m.apply_state(st, v),
                  rtol=1e-5, maxiter=50)

    return step, (_rhs(op, m.device, m.dtype), m.state())


def entry(dims=(16, 16, 16), dtype=np.float32, device=None, amg=None):
    return _amg_cg(*_hierarchy(dims, dtype, device, amg))


def cheb_entry(dims=(16, 16, 16), dtype=np.float32, device=None, amg=None):
    return _amg_cg(*_hierarchy(dims, dtype, device, amg, "chebyshev"))


def block_entry(dims=(16, 16, 16), nrhs=16, dtype=np.float32, device=None,
                amg=None):
    op, m = _hierarchy(dims, dtype, device, amg)

    def step(b_mv: torch.Tensor, st: dict):
        return block_gmres(lambda v: spmv(op, v), b_mv,
                           prec=lambda v: m.apply_state(st, v),
                           num_blocks=25, max_restarts=10, rtol=1e-5,
                           ortho="CGS2")

    return step, (_rhs(op, m.device, m.dtype, nrhs), m.state())


def sstep_entry(dims=(16, 16, 16), dtype=np.float32, device=None):
    op = laplace3d(*dims, dtype=dtype, fmt="stencil")

    def step(b_vec: torch.Tensor):
        return sstep_gmres(op, b_vec, s=4, t_blocks=8, max_restarts=4,
                           rtol=0.0, sigma=12.0)

    return step, (_rhs(op, resolve_device(device), torch_dtype(dtype)),)


def fused_cg_entry(dims=(16, 16, 16), dtype=np.float32, device=None,
                   rtol=1e-5, maxiter=2000):
    op = laplace3d(*dims, dtype=dtype, fmt="stencil")

    def step(b_vec: torch.Tensor):
        return cg_fused(op, b_vec, rtol=rtol, maxiter=maxiter)

    return step, (_rhs(op, resolve_device(device), torch_dtype(dtype)),)
