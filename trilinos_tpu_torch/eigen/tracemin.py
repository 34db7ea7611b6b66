"""TraceMin eigensolver (symmetric, smallest eigenpairs).

Counterpart of ``trilinos_tpu/eigen/tracemin.py`` (Anasazi::TraceMin,
AnasaziTraceMinSolMgr.hpp): minimize trace(YᵀAY) over YᵀMY = I by
alternating an inexact block solve A Z = M Y (a fixed number of
unpreconditioned CG steps per column, no host read inside), CholQR2 of Z
and Rayleigh-Ritz on the new basis. Each outer step reads back the nev
Ritz values and residual norms; the eigenvectors stay on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import torch_dtype
from ..ops.blas import local_dot, mv_trans_mv
from ..parallel.comm import Comm, SerialComm
from ..solvers.base import Operator
from ..solvers.ortho import cholqr2
from .krylov_schur import (EigsResult, _contiguous, _global_rows, _host,
                           _start_block)
from .lobpcg import _rayleigh_ritz


def tracemin(op: Operator, n: int, nev: int, *, block: int | None = None,
             m: Operator | None = None,
             inner_iters: int = 15, tol: float = 1e-8, maxiter: int = 100,
             v0: torch.Tensor | None = None, comm: Comm | None = None,
             dtype=torch.float64, device=None) -> EigsResult:
    """``nev`` smallest eigenpairs of an SPD operator. ``block`` (default
    nev + 2) is the subspace width; the inner solve runs ``inner_iters``
    CG steps per column. ``m``: an SPD mass operator for the pencil
    A x = λ M x (inner solve A Z = M Y, Rayleigh-Ritz whitened with the
    projected mass Gram). ``v0`` (n, block): the start block; without it
    ``default_rng(11)`` normals placed on ``device`` (``None``: the CUDA
    card)."""
    comm = comm or SerialComm()
    dtype = torch_dtype(dtype)
    s = block or min(nev + 2, _global_rows(
        comm, n, v0.device if v0 is not None else device))
    op, mass = _contiguous(op), _contiguous(m)

    def mop(v):
        return v if mass is None else mass(v)

    rng = np.random.default_rng(11)
    if v0 is None:
        v0 = _start_block(rng, n, s, dtype, device)

    def inner_cg(rhs):
        """``inner_iters`` block CG steps on A Z = rhs, column by column."""
        x = torch.zeros_like(rhs)
        r = rhs
        p = r
        rr = comm.psum(local_dot(r, r))
        for _ in range(inner_iters):
            ap = op(p)
            pap = comm.psum(local_dot(p, ap))
            alpha = torch.where(pap > 0, rr / torch.where(pap > 0, pap, 1),
                                0)
            x = x + alpha[None, :] * p
            r = r - alpha[None, :] * ap
            rr_new = comm.psum(local_dot(r, r))
            beta = torch.where(rr > 0, rr_new / torch.where(rr > 0, rr, 1),
                               0)
            p = r + beta[None, :] * p
            rr = rr_new
        return x

    def step(y):
        q, _, _ = cholqr2(comm, inner_cg(mop(y)))
        aq = op(q)
        if mass is None:
            h = comm.psum(mv_trans_mv(q, aq))
            theta, w = torch.linalg.eigh((h + h.T) / 2)  # ascending
            y_new = q @ w
            res = aq @ w - y_new * theta[None, :]
        else:
            mq = mass(q)
            theta, w = _rayleigh_ritz(comm, q, aq, q.shape[1], mq)
            y_new = q @ w
            res = aq @ w - (mq @ w) * theta[None, :]
        return y_new, theta, torch.sqrt(comm.psum(local_dot(res, res)))

    y = cholqr2(comm, v0.to(dtype))[0]
    theta = resn = None
    converged = False
    it = 0
    for it in range(1, maxiter + 1):
        y, theta, resn = step(y)
        theta_np, resn_np = _host(theta[:nev]), _host(resn[:nev])
        scale = np.maximum(np.abs(theta_np), 1.0)
        converged = bool((resn_np <= tol * scale).all())
        if converged:
            break

    return EigsResult(
        eigenvalues=theta_np, eigenvectors=y[:, :nev],
        resnorms=resn_np, iters=it, converged=converged)
