"""The port's paths: the Galeri Laplace3D stencil and 3-D elasticity.

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

``gmres_entry()``: GMRES(30) with CGS2 on the same matrix-free operator,
the JAX bench's ``bench_gmres`` solver; right-preconditioned by the
structured hierarchy when one is given as ``amg=``, with an optional
narrower ``basis_dtype``; ``step(b, state)`` (state None when
unpreconditioned).

``bsr_gmres_entry()``: BASELINE config 2, "Laplace3D 64³ BSR,
Jacobi-preconditioned GMRES(30), multi-vector SpMM nrhs=4": Galeri
Laplace3D stored as a BsrMatrix with b = 4, right-preconditioned by
``Relaxation`` (Jacobi), pseudo-block GMRES(30) on nrhs = 4 seed-1 normals
(the JAX package's BASELINE test), float64, rtol 1e-8, maxiter 1000;
``step(b)``.
``solver`` picks the GMRES variant on the same problem ("gmres",
"fgmres", "single_reduce" or "pipeline"); ``history=True`` (gmres and
fgmres) returns each column's residual trace, whose last finite entry is
that column's iteration count.

``elasticity_entry()``: CG preconditioned by the block-structured
null-space AMG (``BlockStructuredAmg``: rigid-body modes, BDIA levels) on
Galeri ``elasticity3d`` with E = 1, the JAX package's bench configuration
(``"coarse: max size"`` 3000, rtol 1e-5, maxiter 100); ``step(b, state)``.

``bdia_cg_entry()``: unpreconditioned CG on the same operator stored as a
BdiaMatrix, run in plane layout through ``bdia_plane_solver_op`` for a
fixed ``iters`` iterations (rtol 0), the JAX bench's plane-layout solve;
``step(b)`` returns the result with x back in the interleaved layout. An
already packed operator may be passed as ``a=``; grid, dtype and device
then come from it.

Every entry takes ``device`` (``None`` means the CUDA card and raises
without one); the hierarchy paths also take an already-built hierarchy as
``amg=`` so one hierarchy can serve several paths, and their grid, dtype
and device then come from it. Right-hand sides are seed-0 normals with
zero pad rows.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .device import resolve_device, torch_dtype
from .galeri import elasticity3d, laplace3d, rigid_body_modes
from .ops.bdia_spmv import bdia_plane_solver_op
from .ops.formats import csr_to_bdia, csr_to_bsr
from .ops.matvec import spmv
from .precond import BlockStructuredAmg, Relaxation, SaAmg
from .solvers import (block_gmres, cg, cg_fused, fgmres, gmres,
                      gmres_pipeline, gmres_single_reduce, sstep_gmres)


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


def gmres_entry(dims=(16, 16, 16), dtype=np.float32, device=None, amg=None,
                basis_dtype=None, rtol=1e-5, maxiter=1000):
    if amg is None:
        op = laplace3d(*dims, dtype=dtype, fmt="stencil")
        dev, m, st = resolve_device(device), None, None
    else:
        op, m = _hierarchy(dims, dtype, device, amg)
        dev, st = m.device, m.state()

    def step(b_vec: torch.Tensor, st):
        prec = None if st is None else (lambda v: m.apply_state(st, v))
        return gmres(lambda v: spmv(op, v), b_vec, prec=prec, restart=30,
                     rtol=rtol, maxiter=maxiter, ortho="CGS2",
                     basis_dtype=basis_dtype)

    return step, (_rhs(op, dev, torch_dtype(dtype)), st)


_GMRES_VARIANTS = {"gmres": gmres, "fgmres": fgmres,
                   "single_reduce": gmres_single_reduce,
                   "pipeline": gmres_pipeline}


def bsr_gmres_entry(dims=(64, 64, 64), device=None, solver="gmres",
                    history=False):
    solve = _GMRES_VARIANTS[solver]
    extra = {"history": True} if history else {}
    a = laplace3d(*dims)
    dev = resolve_device(device)
    bsr = csr_to_bsr(a, 4, device=dev)
    m = Relaxation(a, device=dev).compute()
    npad, nd = bsr.n_rows_pad, m.dinv.shape[0]

    def prec(v):
        out = m(v[:nd])
        return torch.nn.functional.pad(
            out, (0, 0) * (out.ndim - 1) + (0, npad - out.shape[0]))

    def step(b_mv: torch.Tensor):
        return solve(lambda v: spmv(bsr, v), b_mv, prec=prec, restart=30,
                     rtol=1e-8, maxiter=1000, **extra)

    host = np.zeros((npad, 4))
    host[:a.shape[0]] = np.random.default_rng(1).standard_normal(
        (a.shape[0], 4))
    return step, (torch.from_numpy(host).to(dev),)


def elasticity_entry(dims=(8, 8, 8), dtype=np.float32, device=None,
                     amg=None):
    if amg is None:
        a = elasticity3d(*dims, e_mod=1.0, dtype=dtype)
        amg = BlockStructuredAmg(
            a, {"dtype": dtype, "coarse: max size": 3000}, node_dims=dims,
            nullspace=rigid_body_modes(*dims), n_equations=3,
            device=resolve_device(device)).compute()
    op, m = amg.fine_op, amg

    def step(b_vec: torch.Tensor, st: dict):
        return cg(lambda v: spmv(op, v), b_vec,
                  prec=lambda v: m.apply_state(st, v), rtol=1e-5,
                  maxiter=100)

    return step, (_rhs(op, m.device, m.dtype), m.state())


def bdia_cg_entry(dims=(8, 8, 8), iters=400, dtype=np.float32, device=None,
                  a=None):
    if a is None:
        a = csr_to_bdia(elasticity3d(*dims, e_mod=1.0, dtype=dtype), 3,
                        dtype=dtype, device=resolve_device(device))
    op, pack, unpack = bdia_plane_solver_op(a)

    def step(b_vec: torch.Tensor):
        res = cg(op, pack(b_vec), rtol=0.0, maxiter=iters)
        return dataclasses.replace(res, x=unpack(res.x))

    return step, (_rhs(a, a.data.device, a.dtype),)
