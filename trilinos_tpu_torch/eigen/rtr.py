"""RTR — Riemannian Trust-Region eigensolver (symmetric, smallest).

Counterpart of ``trilinos_tpu/eigen/rtr.py`` (Anasazi::RTRSolMgr / IRTR,
AnasaziRTRSolMgr.hpp, AnasaziIRTR.hpp): minimize trace(XᵀAX) over
{X : XᵀMX = I} with a trust-region outer iteration whose model problem is
solved by truncated CG (Steihaug–Toint) in the tangent space
{η : (MX)ᵀη = 0}, Hess[η] = P(Aη − Mη·(XᵀAX)), with P the Euclidean
projector P(v) = v − MX·((MX)ᵀMX)⁻¹·(MX)ᵀv. Retraction by (M-)CholQR2;
ρ-ratio radius update with ρ regularization.

The tCG's ``lax.while_loop`` becomes a Python loop that reads its stop
test once an inner step. The per-iteration Ritz residuals are formed on
the device (the reference pulls X, AX and MX to the host every outer
iteration to form them): only the p × p XᵀAX and the nev residual norms
are read back. The eigenvectors stay on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import torch_dtype
from ..ops import smalldense
from ..ops.blas import local_dot, mv_trans_mv
from ..parallel.comm import Comm, SerialComm
from ..solvers.base import Operator
from ..solvers.ortho import cholqr2
from .krylov_schur import (EigsResult, _contiguous, _host, _mcholqr2,
                           _start_block)


def rtr(op: Operator, n: int, nev: int, *, block: int | None = None,
        tol: float = 1e-8, maxiter: int = 100, max_inner: int | None = None,
        v0: torch.Tensor | None = None, comm: Comm | None = None,
        dtype=torch.float64, m=None, device=None) -> EigsResult:
    """``nev`` smallest eigenpairs of a symmetric operator. ``m``: an SPD
    mass operator for the pencil A x = λ M x (M-orthonormal iterates,
    pencil residual in the model Hessian, M-weighted tangent projector; no
    M-solve). ``v0`` (n, block): the start block; without it
    ``default_rng(17)`` normals placed on ``device`` (``None``: the CUDA
    card)."""
    comm = comm or SerialComm()
    dtype = torch_dtype(dtype)
    p = block or nev
    max_inner = max_inner or max(4 * p, 40)
    op, mass = _contiguous(op), _contiguous(m)
    rng = np.random.default_rng(17)
    if v0 is None:
        v0 = _start_block(rng, n, p, dtype, device)
    v0 = v0.to(dtype)

    def fsum(a, b):
        return comm.psum((a * b).sum())

    def make_proj(mx, gram_mm):
        """Euclidean projector onto {η : (MX)ᵀη = 0}. gram_mm = (MX)ᵀ(MX)
        is factored once, its floor scaled by its own trace/k (an absolute
        eps floor would dominate a small ‖M‖)."""
        eps = torch.finfo(mx.dtype).eps
        k = gram_mm.shape[0]
        _, linv = smalldense.chol_inv_small(
            (gram_mm + gram_mm.T) / 2 + (10 * eps) * (torch.trace(gram_mm)
                                                      / k)
            * torch.eye(k, dtype=gram_mm.dtype, device=gram_mm.device))

        def proj(v):
            c = comm.psum(mv_trans_mv(mx, v))
            return v - mx @ (linv.T @ (linv @ c))
        return proj

    def rayleigh(x, mx):
        ax = op(x)
        mmat = comm.psum(mv_trans_mv(x, ax))
        mmat = (mmat + mmat.T) / 2
        gram_mm = comm.psum(mv_trans_mv(mx, mx))
        g = make_proj(mx, gram_mm)(ax - mx @ mmat)  # projected residual
        return ax, mmat, gram_mm, g

    def tcg(mx, gram_mm, mmat, g, delta):
        """Truncated CG for Hess[η] = −g within radius ``delta``: negative
        curvature or a boundary hit moves to the boundary along the
        current direction; otherwise run to the inner tolerance (θ = 1,
        κ = 0.1, AnasaziIRTR.hpp). Returns (η, Hη, inner steps, code)."""
        gnorm0 = torch.sqrt(fsum(g, g))
        stop_tol = gnorm0 * torch.clamp(gnorm0, max=0.1)
        proj = make_proj(mx, gram_mm)

        def hess(eta):
            return proj(op(eta) - (mass(eta) if mass is not None
                                   else eta) @ mmat)

        eta = torch.zeros_like(g)
        heta = torch.zeros_like(g)
        r, d = g, -g
        rr = fsum(r, r)
        code = torch.zeros((), dtype=torch.int32, device=g.device)
        it = 0
        while it < max_inner and bool((code == 0)
                                      & (torch.sqrt(rr) > stop_tol)):
            hd = hess(d)
            dhd, dd, ed = fsum(d, hd), fsum(d, d), fsum(eta, d)
            alpha = rr / torch.where(dhd != 0, dhd, 1.0)
            eta_try = eta + alpha * d
            neg_curv = dhd <= 0
            hit = neg_curv | (fsum(eta_try, eta_try) >= delta ** 2)
            # boundary step τ ≥ 0 with ‖η + τ d‖ = delta
            disc = torch.sqrt(torch.clamp(
                ed * ed + dd * (delta ** 2 - fsum(eta, eta)), min=0.0))
            tau = torch.where(dd > 0, (-ed + disc) / torch.where(
                dd > 0, dd, 1), 0.0)
            eta_new = torch.where(hit, eta + tau * d, eta_try)
            heta = torch.where(hit, heta + tau * hd, heta + alpha * hd)
            eta = eta_new
            r = r + alpha * hd  # residual of H η = −g
            rr_new = fsum(r, r)
            beta = rr_new / torch.where(rr != 0, rr, 1.0)
            d = -r + beta * d
            rr = rr_new
            code = torch.where(hit, torch.where(neg_curv, 1, 2),
                               0).to(torch.int32)
            it += 1
        return eta, heta, it, code

    def retract(x, eta):
        w = x + eta
        if mass is None:
            q, _, _ = cholqr2(comm, w)
            return q, q
        return _mcholqr2(comm, mass, w)

    def ritz(x, ax, mx, mmat):
        """Ritz values, vectors and residual norms of the block: the p × p
        eigh on the host (as the reference's), the n × p products on the
        device."""
        mm = _host(mmat)
        w, z = np.linalg.eigh((mm + mm.T) / 2)
        zt = torch.as_tensor(z, device=x.device)
        wt = torch.as_tensor(w, device=x.device)
        ra = ax @ zt - (mx @ zt) * wt[None, :]
        rn = ra[:, :nev]
        return w, x @ zt, _host(torch.sqrt(comm.psum(local_dot(rn, rn))))

    x, mx = retract(v0, torch.zeros_like(v0))
    # initial trust radius: the actual ‖X‖_F (an M-orthonormal block has
    # column norms ~ 1/√‖M‖, √p only when M = I)
    delta = float(torch.sqrt(fsum(x, x)))
    delta_bar = 10 * delta
    rho_prime = 0.1

    converged = False
    iters = 0
    ax, mmat, gram_mm, g = rayleigh(x, mx)
    f_cur = float(torch.trace(mmat))

    for it in range(maxiter):
        iters = it + 1
        # convergence: per-column pencil Ritz residuals
        w, _, resn = ritz(x, ax, mx, mmat)
        scale = np.maximum(np.abs(w[:nev]), 1.0)
        converged = bool((resn <= tol * scale).all())
        if converged:
            break
        eta, heta, _, code = tcg(mx, gram_mm, mmat, g,
                                 torch.tensor(delta, dtype=dtype,
                                              device=x.device))
        x_try, mx_try = retract(x, eta)
        ax_t, mmat_t, gram_t, g_t = rayleigh(x_try, mx_try)
        f_try = float(torch.trace(mmat_t))
        mdec = float(-(fsum(g, eta) + 0.5 * fsum(eta, heta)))
        # rho regularization (AnasaziRTRBase's fx-vs-model guard): near
        # convergence both decreases fall to rounding noise and the raw
        # ratio would reject good steps forever
        reg = 1e3 * np.finfo(np.float64).eps * max(1.0, abs(f_cur))
        rho = (f_cur - f_try + reg) / (max(mdec, 0.0) + reg)
        if rho < 0.25:
            delta = delta / 4
        elif rho > 0.75 and int(code) in (1, 2):
            delta = min(2 * delta, delta_bar)
        if rho > rho_prime:
            x, mx, ax, mmat, gram_mm, g, f_cur = (
                x_try, mx_try, ax_t, mmat_t, gram_t, g_t, f_try)

    # final Ritz extraction
    w, xa, resn = ritz(x, ax, mx, mmat)
    return EigsResult(
        eigenvalues=w[:nev], eigenvectors=xa[:, :nev],
        resnorms=resn, iters=iters, converged=converged)
