"""Communication-avoiding GMRES variants: single-reduce and pipelined.

Counterpart of ``trilinos_tpu/solvers/gmres_ca.py`` (Belos' native Tpetra
GmresSingleReduce and GmresPipeline):

* ``gmres_single_reduce``: one fused reduction per Arnoldi step, [Vᵀw;
  wᵀw], with the new vector's norm from ‖w − Vh‖² = wᵀw − hᵀh;
* ``gmres_pipeline``: Ghysels p(1) pipelined GMRES; the reduction of step j
  is issued before the next operator apply u = A M z_j, and the shadow
  basis Z = (A∘M) V is corrected afterwards.

Both restart on the true residual and report an explicitly recomputed one.
A multivector runs column by column in batch, each column frozen once its
loops end, as in :mod:`.gmres` (which holds the layout and the host-side
Givens state they share).
"""
from __future__ import annotations

import numpy as np
import torch

from ..parallel.comm import Comm, SerialComm
from .base import Operator, SolveResult, identity_prec
from .gmres import (Lsq, finish, host, inv_or_inf, local_row_dots,
                    row_norms, rows_op, to_rows, tolerance)


def _ca_rows(b, x0, A, M, *, restart, maxiter, rtol, atol, comm,
             pipelined):
    k, n = b.shape
    m = restart
    dev = b.device
    bnorm = host(row_norms(comm, b))
    tol = tolerance(bnorm, rtol, atol)
    v = torch.zeros((k, m + 1, n), dtype=b.dtype, device=dev)
    z = torch.zeros_like(v) if pipelined else None

    def cycle(x, total, run):
        run_t = torch.from_numpy(run).to(dev)
        r0 = b - A(x)
        beta = host(row_norms(comm, r0))
        v[:, 0] = r0 / inv_or_inf(torch.from_numpy(beta).to(dev),
                                  run_t)[:, None]
        if pipelined:
            z[:, 0] = A(M(v[:, 0]))
        lsq = Lsq(beta, m)
        jc = np.zeros(k, np.int64)
        act, j = run & (m > 0) & (np.abs(lsq.g[:, 0]) > tol), 0
        while act.any():
            act_t = torch.from_numpy(act).to(dev)
            vp = v[:, :j + 1]
            w = z[:, j] if pipelined else A(M(v[:, j]))
            # ONE reduction: [Vᵀw ; wᵀw]
            d = comm.psum(torch.cat([torch.bmm(vp, w[:, :, None])[:, :, 0],
                                     local_row_dots(w, w)[:, None]], dim=1))
            if pipelined:
                u = A(M(w))  # issued before the reduction is consumed
            hcol, ww = d[:, :j + 1], d[:, j + 1]
            w2 = torch.baddbmm(w[:, :, None], vp.transpose(1, 2),
                               hcol[:, :, None], alpha=-1)[:, :, 0]
            hnorm = torch.sqrt(torch.clamp(ww - (hcol * hcol).sum(dim=1),
                                           min=0))
            den = inv_or_inf(hnorm, act_t)[:, None]
            if pipelined:
                inv = 1 / den
                v[:, j + 1] = w2 * inv
                zc = torch.baddbmm(u[:, :, None], z[:, :j + 1].transpose(1, 2),
                                   hcol[:, :, None], alpha=-1)[:, :, 0]
                z[:, j + 1] = zc * inv
            else:
                v[:, j + 1] = w2 / den
            got = host(torch.cat([hcol, hnorm[:, None]], dim=1))
            h = np.zeros((k, m + 1), got.dtype)
            h[:, :j + 2] = got
            a = np.flatnonzero(act)
            lsq.step(h, j, a)
            jc[a] = j + 1
            j += 1
            act = act & (j < m) & (np.abs(lsq.g[:, j]) > tol)
        jmax = int(jc.max(initial=0))
        if jmax:
            y = torch.from_numpy(lsq.solve(jc)).to(dev)[:, :, None]
            x_new = x + M(torch.bmm(v[:, :jmax].transpose(1, 2), y)[:, :, 0])
            x = x_new if run.all() else torch.where(run_t[:, None], x_new, x)
        # single-pass CGS can lose orthogonality and make |g[j]| read low:
        # restarts are gated on the true residual
        return x, total + jc, host(row_norms(comm, b - A(x)))

    x, total, res = cycle(x0, np.zeros(k, np.int64), np.ones(k, bool))
    while True:
        run = (total < maxiter) & (res > tol)
        if not run.any():
            break
        x, total, res_new = cycle(x, total, run)
        res = np.where(run, res_new, res)
    res_true = host(row_norms(comm, b - A(x)))
    return x, total, res_true, tol


def _wrap(op, b, x0, prec, restart, maxiter, rtol, atol, comm, pipelined):
    comm = comm or SerialComm()
    one_d = b.ndim == 1
    x0 = torch.zeros_like(b) if x0 is None else x0
    x, total, res, tol = _ca_rows(
        to_rows(b), to_rows(x0), rows_op(op, one_d),
        rows_op(prec or identity_prec, one_d), restart=restart,
        maxiter=maxiter, rtol=rtol, atol=atol, comm=comm,
        pipelined=pipelined)
    return finish(x, total, res, tol, one_d, b.device)


def gmres_single_reduce(op: Operator, b: torch.Tensor,
                        x0: torch.Tensor | None = None, *,
                        prec: Operator | None = None, restart: int = 30,
                        maxiter: int = 1000, rtol: float = 1e-8,
                        atol: float = 0.0,
                        comm: Comm | None = None) -> SolveResult:
    """GMRES(m) with one fused reduction per Arnoldi step."""
    return _wrap(op, b, x0, prec, restart, maxiter, rtol, atol, comm, False)


def gmres_pipeline(op: Operator, b: torch.Tensor,
                   x0: torch.Tensor | None = None, *,
                   prec: Operator | None = None, restart: int = 30,
                   maxiter: int = 1000, rtol: float = 1e-8,
                   atol: float = 0.0, comm: Comm | None = None) -> SolveResult:
    """Ghysels p(1) pipelined GMRES(m): reduction overlapped with the
    operator apply."""
    return _wrap(op, b, x0, prec, restart, maxiter, rtol, atol, comm, True)
