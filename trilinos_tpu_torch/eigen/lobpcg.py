"""LOBPCG — locally optimal block preconditioned conjugate gradients.

Counterpart of ``trilinos_tpu/eigen/lobpcg.py`` (Anasazi::LOBPCG,
AnasaziLOBPCGSolMgr.hpp): each iteration is one block apply, one
preconditioner apply on the residual block, two CholQR2 panels and a small
(3·nev)² Rayleigh-Ritz problem whitened SVQB-style. The JAX package's
``lax.while_loop`` becomes a Python loop whose test ``k < maxiter and
any(rn > tol)`` reads the residual norms once an iteration, where the
reference's ``cond`` reads them; the projected problems are
``torch.linalg.eigh`` on the block's device, as the reference runs
``jnp.linalg.eigh`` on its own.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops.blas import local_dot, mv_trans_mv
from ..parallel.comm import Comm, SerialComm
from ..solvers.base import Operator, identity_prec
from ..solvers.ortho import cholqr2


@dataclasses.dataclass
class EigenResult:
    eigenvalues: torch.Tensor  # (nev,)
    eigenvectors: torch.Tensor  # (n, nev)
    iters: int
    resnorms: torch.Tensor  # (nev,)


def _rayleigh_ritz(comm: Comm, s: torch.Tensor, a_s: torch.Tensor, nev: int,
                   m_s: torch.Tensor | None = None):
    """The projected problem on basis S: (SᵀAS) y = θ (SᵀMS) y, M = I when
    ``m_s`` is None and ``m_s = M·S`` for a pencil. SᵀMS = U Λ Uᵀ is
    whitened on the directions with Λ > 1e3·eps·max Λ (eigendecomposition,
    not Cholesky: near convergence the [X W P] blocks are dependent to
    rounding and the Gram picks up slightly negative eigenvalues); the
    discarded directions get 1e30 on the diagonal so the nev-smallest
    selection never picks them. Returns (θ[:nev], y[:, :nev])."""
    g_a = comm.psum(mv_trans_mv(s, a_s))
    g_m = comm.psum(mv_trans_mv(s, m_s if m_s is not None else s))
    eps = torch.finfo(s.dtype).eps
    tiny = torch.finfo(s.dtype).tiny
    lam_m, u_m = torch.linalg.eigh((g_m + g_m.T) / 2)
    good = lam_m > 1e3 * eps * torch.clamp(lam_m.max(), min=eps)
    inv_sqrt = torch.where(good, 1.0 / torch.sqrt(torch.clamp(lam_m,
                                                              min=tiny)), 0.0)
    t = u_m * inv_sqrt[None, :]
    a_w = t.T @ ((g_a + g_a.T) / 2) @ t
    a_w = a_w + torch.diag(torch.where(good, 0.0, 1e30).to(s.dtype))
    theta, y_w = torch.linalg.eigh((a_w + a_w.T) / 2)
    y = t @ y_w
    return theta[:nev], y[:, :nev]


def lobpcg(op: Operator, x0: torch.Tensor, *, prec: Operator | None = None,
           m: Operator | None = None, which: str = "SM", tol: float = 1e-6,
           maxiter: int = 200, comm: Comm | None = None) -> EigenResult:
    """The ``nev = x0.shape[1]`` smallest ("SM") or largest (any other
    ``which``) eigenpairs of the symmetric operator ``op``, residual norms
    ≤ ``tol``. ``m``: an SPD mass operator for the pencil A x = λ M x; the
    basis stays Euclidean-orthonormal, M enters through SᵀMS and the
    residual r = A x − M x θ."""
    comm = comm or SerialComm()
    M = prec or identity_prec
    nev = x0.shape[1]
    sign = 1.0 if which == "SM" else -1.0
    a = op if which == "SM" else (lambda v: -op(v))
    mass = m

    def mop(v):
        return v if mass is None else mass(v)

    def resnorms(ax, mx, theta):
        r = ax - mx * theta[None, :]
        return torch.sqrt(comm.psum(local_dot(r, r)))

    x, _, _ = cholqr2(comm, x0)
    ax = a(x)
    mx = mop(x)
    theta, y = _rayleigh_ritz(comm, x, ax, nev,
                              mx if mass is not None else None)
    x = x @ y
    ax = ax @ y
    mx = x if mass is None else mx @ y
    p = torch.zeros_like(x)
    rn = resnorms(ax, mx, theta)
    k = 0
    while k < maxiter and bool((rn > tol).any()):
        w = M(ax - mx * theta[None, :])
        w, _, _ = cholqr2(comm, w)
        if k > 0:
            p_n, _, _ = cholqr2(comm, p)
            ap, mp = a(p_n), mop(p_n)
        else:  # no search direction yet: the reference's masked zeros
            p_n = ap = mp = torch.zeros_like(p)
        s = torch.cat([x, w, p_n], dim=1)
        a_s = torch.cat([ax, a(w), ap], dim=1)
        m_s = (torch.cat([mx, mop(w), mp], dim=1) if mass is not None
               else None)
        theta, y = _rayleigh_ritz(comm, s, a_s, nev, m_s)
        x = s @ y
        ax = a_s @ y
        mx = x if mass is None else m_s @ y
        # p = component of the update outside the current x
        p = s[:, nev:] @ y[nev:, :]
        rn = resnorms(ax, mx, theta)
        k += 1
    return EigenResult(eigenvalues=sign * theta, eigenvectors=x, iters=k,
                       resnorms=rn)


def power_method(op: Operator, v0: torch.Tensor, *, maxiter: int = 100,
                 tol: float = 1e-8, comm: Comm | None = None):
    """Largest-|λ| eigenpair by the power method. Returns (λ, v, iters);
    the loop reads |λ_new − λ| > tol·|λ| once an iteration."""
    comm = comm or SerialComm()

    def norm(v):
        return torch.sqrt(comm.psum(local_dot(v, v)))

    lam = norm(v0)
    v = v0 / lam
    delta = torch.full_like(lam, float("inf"))
    k = 0
    while k < maxiter and bool(delta > tol * lam.abs()):
        w = op(v)
        lam_new = norm(w)
        v = w / torch.clamp(lam_new, min=1e-300)
        delta = (lam_new - lam).abs()
        lam = lam_new
        k += 1
    return lam, v, k
