"""Spectral transformation: shift-invert eigensolving.

Counterpart of ``trilinos_tpu/eigen/spectral.py``: interior eigenvalues
through the transformed operator (A − σI)⁻¹, Anasazi's shift-and-invert
mode. The inverse apply is an inner Krylov solve per outer apply (MINRES
by default: A − σI is symmetric indefinite for an interior shift), so the
transformed operator stays matrix-free. Its eigenvalues are
θ = 1/(λ − σ); ``eigs_near`` recovers λ = σ + 1/θ.
"""
from __future__ import annotations

import torch

from ..parallel.comm import Comm
from .lanczos import lanczos_eigs


def shift_invert(op, sigma: float, *, solver=None,
                 rtol: float | None = None, maxiter: int = 1000,
                 prec=None):
    """The operator v ↦ (A − σI)⁻¹ v (an inner ``solver`` solve per apply,
    MINRES by default). ``rtol`` defaults by the vector's dtype at apply
    time: 1e-10 in f64, 1e-6 in f32 (an f32 inner solve cannot reach
    1e-10)."""
    if solver is None:
        from ..solvers.minres import minres as solver

    def shifted(v):
        return op(v) - sigma * v

    def apply(v):
        tol = rtol
        if tol is None:
            tol = 1e-10 if v.dtype == torch.float64 else 1e-6
        res = solver(shifted, v, rtol=tol, maxiter=maxiter,
                     **({"prec": prec} if prec is not None else {}))
        return res.x

    return apply


def eigs_near(op, sigma: float, nev: int, v0: torch.Tensor, *,
              m: int | None = None, inner_rtol: float | None = None,
              inner_maxiter: int = 1000, comm: Comm | None = None):
    """Eigenpairs of the symmetric ``op`` nearest ``sigma``: Lanczos on
    (A − σI)⁻¹, then λ = σ + 1/θ. Returns (eigenvalues (nev,),
    eigenvectors (n, nev)) sorted by |λ − σ|."""
    sinv = shift_invert(op, sigma, rtol=inner_rtol, maxiter=inner_maxiter)
    theta, vecs = lanczos_eigs(sinv, v0, nev, m, which="LM", comm=comm)
    lam = sigma + 1.0 / theta
    order = torch.argsort((lam - sigma).abs())
    return lam[order], vecs[:, order]
