"""Generalized Davidson eigensolver (nonsymmetric, preconditioned).

Counterpart of ``trilinos_tpu/eigen/gen_davidson.py``
(Anasazi::GeneralizedDavidson, AnasaziGeneralizedDavidsonSolMgr.hpp):
expand a search space with preconditioned residual blocks, project the
nonsymmetric operator onto it, take the wanted invariant subspace from a
sorted real Schur form of the small projected matrix (conjugate pairs stay
2×2 blocks, the reference's xGEES path) and restart by collapsing onto it.

The n-sized work (projections, Schur vectors, residuals, CGS2 + CholQR2)
runs on the basis's device; the k × k Schur sort runs in scipy on the
host, f64 for an f64 solve, from the projected matrix alone. The
eigenvectors (the real invariant subspace) stay on the device.
"""
from __future__ import annotations

import numpy as np
import scipy.linalg as sla
import torch

from ..device import torch_dtype
from ..ops.blas import local_dot, mv_trans_mv
from ..parallel.comm import Comm, SerialComm
from ..solvers.base import Operator
from ..solvers.ortho import cgs2_project, cholqr2
from .krylov_schur import (EigsResult, _contiguous, _expansion_quality,
                           _filter_rescale_block, _global_rows, _host,
                           _mcholqr2, _mortho_block, _start_block)


def _schur_select(h: np.ndarray, nsel: int, which: str):
    """Sorted real Schur form of the projected matrix: (t, z, vals, sdim)
    with the ``nsel`` wanted eigenvalues leading (a conjugate pair is kept
    whole, so the leading block may be nsel + 1 wide)."""
    t, z = sla.schur(h, output="real")
    vals = sla.eigvals(t)
    key = {
        "LM": lambda w: -np.abs(w),
        "SM": lambda w: np.abs(w),
        "LR": lambda w: -w.real,
        "SR": lambda w: w.real,
    }[which](vals)
    order = np.argsort(key, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    # a 2x2 block is selected if either of its eigenvalues is
    sel = rank < nsel
    t, z, sdim = sla.schur(h, output="real",
                           sort=lambda wr, wi: bool(
                               sel[np.argmin(np.abs(vals - (wr + 1j * wi)))]))
    return t, z, sla.eigvals(t), max(int(sdim), 1)


def generalized_davidson(op: Operator, n: int, nev: int, *,
                         nb: int | None = None, smax: int | None = None,
                         prec=None, which: str = "LM", tol: float = 1e-8,
                         maxiter: int = 200, v0: torch.Tensor | None = None,
                         comm: Comm | None = None,
                         dtype=torch.float64, m=None,
                         device=None) -> EigsResult:
    """``nev`` eigenvalues of a general real operator, which LM / SM / LR /
    SR. Eigenvalues come back complex; ``eigenvectors`` spans the real
    invariant subspace (columns pair up for conjugate eigenvalues).

    ``m``: an SPD mass operator for the pencil A x = λ M x: the search
    space is kept M-orthonormal, so the projected pencil is the standard
    SᵀAS z = λ z (whitened against the measured M-Gram) and the residual
    is r = A x − (M x)·T. ``v0`` (n, nb): the start block; without it
    ``default_rng(13)`` normals placed on ``device`` (``None``: the CUDA
    card). The refill columns draw from the same stream."""
    comm = comm or SerialComm()
    dtype = torch_dtype(dtype)
    nb = nb or nev
    smax = smax or max(4 * nev, 6 * nb)
    n_all = _global_rows(comm, n, v0.device if v0 is not None else device)
    smax = min(smax, (n_all // nb) * nb)
    op = _contiguous(op)
    prec = _contiguous(prec) or (lambda r: r)
    mass = _contiguous(m)
    rng = np.random.default_rng(13)

    def _whitened_schur(h, g):
        """Sorted real Schur of the projected pencil against the measured
        M-Gram: G = L Lᵀ, h̃ = L⁻¹ h L⁻ᵀ, z = L⁻ᵀ z̃ (M-orthonormal
        combinations, so restarts keep M-orthonormality). mass None: G = I
        and the plain sort."""
        if mass is None:
            return _schur_select(h, nev, which)
        g = (g + g.T) / 2
        eps = np.finfo(h.dtype).eps
        k = h.shape[0]
        lmat = np.linalg.cholesky(
            g + (10 * eps) * (np.trace(g) / k) * np.eye(k, dtype=g.dtype))
        y = sla.solve_triangular(lmat, h, lower=True)
        hw = sla.solve_triangular(lmat, y.T, lower=True).T
        t, zt, vals, sdim = _schur_select(hw, nev, which)
        return t, sla.solve_triangular(lmat.T, zt, lower=False), vals, sdim

    def expand(s, ms_, t, k):
        if mass is None:
            t2, _ = cgs2_project(comm, s, t)
            q, _, _ = cholqr2(comm, t2)
            return q, q, None, None
        q, mq = _mortho_block(comm, mass, s, ms_, t)
        # block quality: the host filters and rescales before insertion
        bq, cmax = _expansion_quality(comm, q, mq, ms_, k)
        return q, mq, bq, cmax

    if v0 is None:
        v0 = _start_block(rng, n, nb, dtype, device)
    v0 = v0.to(dtype)
    dev = v0.device
    if mass is None:
        q0, _, _ = cholqr2(comm, v0)
        mq0 = q0
    else:
        q0, mq0 = _mcholqr2(comm, mass, v0)
    s = torch.zeros((n, smax), dtype=dtype, device=dev)
    as_ = torch.zeros_like(s)
    s[:, :nb] = q0
    as_[:, :nb] = op(q0)
    if mass is not None:
        ms_ = torch.zeros_like(s)
        ms_[:, :nb] = mq0
    else:
        ms_ = s
    k = nb
    vals = x = resn = None
    converged = False
    iters = 0

    for it in range(maxiter):
        iters = it + 1
        h = comm.psum(mv_trans_mv(s[:, :k], as_[:, :k]))
        g = (comm.psum(mv_trans_mv(s[:, :k], ms_[:, :k]))
             if mass is not None else None)
        t, z, w, msel = _whitened_schur(_host(h),
                                        None if g is None else _host(g))
        msel = min(msel, k)
        zsel = torch.as_tensor(z[:, :msel], dtype=dtype, device=dev)
        tmm = torch.as_tensor(t[:msel, :msel], dtype=dtype, device=dev)
        x = s[:, :k] @ zsel
        mx = ms_[:, :k] @ zsel if mass is not None else x
        r = as_[:, :k] @ zsel - mx @ tmm
        resn = torch.sqrt(comm.psum(local_dot(r, r)))
        vals = w[:msel]
        scale = np.maximum(np.abs(np.asarray(vals)), 1.0)
        converged = bool(
            (_host(resn)[:min(nev, msel)]
             <= tol * scale[:min(nev, msel)]).all())
        if converged:
            break
        if k + nb > smax:
            # restart: collapse onto the leading sorted Schur basis
            keep = min(max(2 * nev, nb), smax - nb, k)
            zk = torch.as_tensor(z[:, :keep], dtype=dtype, device=dev)
            for buf in ((s, as_) if mass is None else (s, as_, ms_)):
                prod = buf[:, :k] @ zk
                buf.zero_()
                buf[:, :keep] = prod
            k = keep
            continue
        # expansion: the preconditioned residual block of the leading
        # min(nb, msel) directions
        blk = r[:, :min(nb, msel)]
        if blk.shape[1] < nb:
            # fill with random combinations of the cached A·S columns:
            # fresh directions that stay in the true (zero-pad-row)
            # subspace
            c = torch.as_tensor(rng.standard_normal((k, nb - blk.shape[1])),
                                dtype=dtype, device=dev)
            blk = torch.cat([blk, as_[:, :k] @ c], dim=1)
        q, mq, bq, cmax = expand(s, ms_, prec(blk), k)
        if mass is not None:
            filtered = _filter_rescale_block(q, mq, bq, cmax)
            if filtered is None:
                break  # expansion fully degenerate: honest stagnation
            q, mq = filtered
        g = q.shape[1]
        s[:, k:k + g] = q
        as_[:, k:k + g] = op(q)
        if mass is not None:
            ms_[:, k:k + g] = mq
        k += g

    return EigsResult(
        eigenvalues=np.asarray(vals), eigenvectors=x,
        resnorms=_host(resn), iters=iters, converged=converged)
