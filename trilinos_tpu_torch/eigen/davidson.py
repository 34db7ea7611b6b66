"""Block Davidson eigensolver (symmetric, preconditioned).

Counterpart of ``trilinos_tpu/eigen/davidson.py`` (Anasazi::BlockDavidson,
AnasaziBlockDavidsonSolMgr.hpp): expand a search space with preconditioned
residual blocks, Rayleigh-Ritz on the space, restart onto the leading Ritz
block when the space is full; optional locking of converged pairs ("Use
Locking", "Locking Tolerance" 0.1·tol, "Max Locked" nev,
AnasaziBlockDavidsonSolMgr.hpp:153-157).

Each step's n-sized work (projection, Ritz block and residuals,
preconditioner apply, CGS2 + CholQR2 or the M-metric orthonormalization of
the new block) runs on the basis's device; the step reads back the
residual norms and selected Ritz values (and, with a mass, the new block's
nb × nb quality measures), as the reference's host loop reads them. The
small eigh runs on the device, as the reference's does. The eigenvectors
stay on the device.

Locking layout: basis columns [0, nlock) hold frozen converged Ritz
vectors, the active space is [nlock, k); Rayleigh-Ritz runs on the active
slice and expansion blocks are orthogonalized against the whole basis.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import torch_dtype
from ..ops import smalldense
from ..ops.blas import local_dot, mv_trans_mv
from ..parallel.comm import Comm, SerialComm
from ..solvers.base import Operator
from ..solvers.ortho import cgs2_project, cholqr2
from .krylov_schur import (EigsResult, _contiguous, _expansion_quality,
                           _filter_rescale_block, _global_rows, _host,
                           _mcholqr2, _mortho_block, _start_block)


def block_davidson(op: Operator, n: int, nev: int, *, nb: int | None = None,
                   smax: int | None = None, prec=None, which: str = "SA",
                   tol: float = 1e-8, maxiter: int = 200,
                   v0: torch.Tensor | None = None, comm: Comm | None = None,
                   dtype=torch.float64, m=None, locking: bool = False,
                   lock_tol: float | None = None,
                   max_locked: int | None = None,
                   device=None) -> EigsResult:
    """``nev`` extreme eigenpairs of a symmetric operator: which SA
    (smallest algebraic) or LA. ``prec`` approximates (A − σI)⁻¹.

    ``m``: an SPD mass operator for the pencil A x = λ M x: the search
    space is kept M-orthonormal, so the projected problem stays standard
    (whitened against the measured M-Gram), residuals r = A x − M x θ, and
    each new block passes the host's quality filter.

    ``locking``: pairs whose residual reaches ``lock_tol`` (default
    0.1·tol) freeze in a locked prefix, up to ``max_locked`` (default
    nev). ``v0`` (n, nb): the start block; without it ``default_rng(7)``
    normals placed on ``device`` (``None``: the CUDA card)."""
    comm = comm or SerialComm()
    dtype = torch_dtype(dtype)
    nb = nb or nev
    smax = smax or max(4 * nev, 6 * nb)
    n_all = _global_rows(comm, n, v0.device if v0 is not None else device)
    smax = min((smax // nb) * nb, (n_all // nb) * nb)
    op = _contiguous(op)
    prec = _contiguous(prec) or (lambda r: r)
    mass = _contiguous(m)
    lock_tol = lock_tol if lock_tol is not None else 0.1 * tol
    max_locked = max_locked if max_locked is not None else nev
    rng = np.random.default_rng(7)

    def _whitened_eigh(kmat, s_a, ms_a):
        """Rayleigh-Ritz against the measured M-Gram G = SᵀMS = L Lᵀ:
        K̃ = L⁻¹ K L⁻ᵀ, z = L⁻ᵀ z̃, so drift in the basis's M-orthonormality
        costs efficiency, never the reported Ritz values. mass None: plain
        eigh."""
        ka = kmat.shape[0]
        if mass is None:
            return torch.linalg.eigh(kmat)
        gmat = comm.psum(mv_trans_mv(s_a, ms_a))
        gmat = (gmat + gmat.T) / 2
        eps = torch.finfo(kmat.dtype).eps
        gmat = gmat + (10 * eps) * (torch.trace(gmat) / ka) * torch.eye(
            ka, dtype=gmat.dtype, device=gmat.device)
        linv = smalldense.chol_inv_small(gmat)[1]
        hw = linv @ kmat @ linv.T
        theta, zt = torch.linalg.eigh((hw + hw.T) / 2)
        return theta, linv.T @ zt

    def _wanted_cols(z, theta, ka, width):
        """The leading ``width`` wanted directions of the active
        projection (SA: ascending head; LA: descending tail)."""
        if which == "SA":
            return z[:, :width], theta[:width]
        return (z[:, ka - width:].flip(1), theta[ka - width:].flip(0))

    def step(s, as_, ms_, k, nlock):
        ka = k - nlock
        nsel = min(max(nev - nlock, 1), ka)
        nbw = min(nb, ka)
        s_a, as_a, ms_a = s[:, nlock:k], as_[:, nlock:k], ms_[:, nlock:k]
        kmat = comm.psum(mv_trans_mv(s_a, as_a))
        kmat = (kmat + kmat.T) / 2
        theta, z = _whitened_eigh(kmat, s_a, ms_a)  # ascending
        zsel, tsel = _wanted_cols(z, theta, ka, nsel)
        zblk, tblk = _wanted_cols(z, theta, ka, nbw)
        x = s_a @ zsel
        ax = as_a @ zsel
        mx = ms_a @ zsel if mass is not None else x
        r = ax - mx * tsel[None, :]
        resn = torch.sqrt(comm.psum(local_dot(r, r)))
        # expansion block: preconditioned residuals of the leading nbw
        xb = (ms_a if mass is not None else s_a) @ zblk
        t = prec(as_a @ zblk - xb * tblk[None, :])
        if mass is None:
            t2, _ = cgs2_project(comm, s, t)  # the padded basis is fine
            q, _, _ = cholqr2(comm, t2)
            return theta, z, tsel, x, resn, q, q, None, None
        # a near-singular block (converged residuals) defeats M-CholQR in
        # f32; the host filters and rescales on these measures
        q, mq = _mortho_block(comm, mass, s, ms_, t)
        bq, cmax = _expansion_quality(comm, q, mq, ms_, k)
        return theta, z, tsel, x, resn, q, mq, bq, cmax

    def rotate_active(s, as_, ms_, k, nlock, zk):
        """S_a ← S_a z (and its caches) in place, keeping zk's columns:
        the active columns become Ritz vectors (locking, restarts)."""
        ka_new = zk.shape[1]
        for buf in ((s, as_) if mass is None else (s, as_, ms_)):
            prod = buf[:, nlock:k] @ zk
            buf[:, nlock:] = 0
            buf[:, nlock:nlock + ka_new] = prod

    if v0 is None:
        v0 = _start_block(rng, n, nb, dtype, device)
    v0 = v0.to(dtype)
    if mass is None:
        q0, _, _ = cholqr2(comm, v0)
        mq0 = q0
    else:
        q0, mq0 = _mcholqr2(comm, mass, v0)
    s = torch.zeros((n, smax), dtype=dtype, device=v0.device)
    as_ = torch.zeros_like(s)
    s[:, :nb] = q0
    as_[:, :nb] = op(q0)
    if mass is not None:
        ms_ = torch.zeros_like(s)
        ms_[:, :nb] = mq0
    else:
        ms_ = s
    k = nb
    nlock = 0
    locked_theta: list[float] = []
    locked_resn: list[float] = []
    tsel = x = resn = None
    converged = False
    iters = 0

    for it in range(maxiter):
        iters = it + 1
        theta_a, z, tsel, x, resn, q, mq, bq, cmax = step(s, as_, ms_, k,
                                                          nlock)
        resn_np = _host(resn)
        tsel_np = _host(tsel)
        scale = np.maximum(np.abs(tsel_np), 1.0)
        need = nev - nlock
        conv_mask = resn_np[:need] <= tol * scale[:need]
        converged = bool(conv_mask.all()) and need <= len(resn_np)
        if converged:
            break
        if locking and nlock < max_locked:
            # lock the leading consecutive pairs at the locking tolerance
            lockable = resn_np <= lock_tol * scale
            g = 0
            while (g < len(lockable) and lockable[g]
                   and nlock + g < max_locked):
                g += 1
            g = min(g, k - nlock - 1)  # keep ≥ 1 active column
            if g > 0:
                ka = k - nlock
                # rotate the whole active space onto its Ritz basis
                # (wanted first); the first g become locked
                zfull, tfull = _wanted_cols(z, theta_a, ka, ka)
                rotate_active(s, as_, ms_, k, nlock, zfull)
                locked_theta.extend(_host(tfull)[:g].tolist())
                locked_resn.extend(resn_np[:g].tolist())
                nlock += g
                continue  # re-project against the shrunken active space
        if k + nb > smax:
            # restart: collapse the active space onto the leading Ritz
            # block(s); z has orthonormal columns, so S·z stays
            # (M-)orthonormal
            ka = k - nlock
            keep = min(max(2 * (nev - nlock), nb), smax - nlock - nb, ka)
            keep = max(keep, 1)
            zk, _ = _wanted_cols(z, theta_a, ka, keep)
            rotate_active(s, as_, ms_, k, nlock, zk)
            k = nlock + keep
            continue
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

    # results: the locked prefix, then the active leading pairs
    n_active_out = nev - nlock
    if n_active_out > 0 and x is not None:
        theta_out = np.concatenate([np.asarray(locked_theta),
                                    _host(tsel)[:n_active_out]])
        vecs_out = torch.cat([s[:, :nlock], x[:, :n_active_out]], dim=1)
        resn_out = np.concatenate([np.asarray(locked_resn),
                                   _host(resn)[:n_active_out]])
    else:
        theta_out = np.asarray(locked_theta)[:nev]
        vecs_out = s[:, :min(nlock, nev)].clone()
        resn_out = np.asarray(locked_resn)[:nev]
        converged = len(theta_out) >= nev
    return EigsResult(
        eigenvalues=theta_out, eigenvectors=vecs_out,
        resnorms=resn_out, iters=iters, converged=converged)
