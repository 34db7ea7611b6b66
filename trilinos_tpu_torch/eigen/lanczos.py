"""Arnoldi and Lanczos factorizations.

Counterpart of ``trilinos_tpu/eigen/lanczos.py`` (the Arnoldi/Lanczos
factorization under Anasazi's Krylov eigensolvers): a fixed-length
factorization with full CGS2 reorthogonalization and a host-size projected
eigensolve. The basis is stored one vector per row, (m+1, n), so each
basis vector is contiguous for the operator; ``v`` below is its (n, m+1)
transposed view, the JAX package's layout.
"""
from __future__ import annotations

import torch

from ..parallel.comm import Comm, SerialComm, norm2
from ..solvers.base import Operator, safe_divide
from ..solvers.ortho import cgs2_project


def arnoldi(op: Operator, v0: torch.Tensor, m: int, *,
            comm: Comm | None = None):
    """m-step Arnoldi with CGS2: returns (V (n, m+1), H (m+1, m))."""
    comm = comm or SerialComm()
    n = v0.shape[0]
    vt = torch.zeros((m + 1, n), dtype=v0.dtype, device=v0.device)
    v = vt.T
    h = torch.zeros((m + 1, m), dtype=v0.dtype, device=v0.device)
    vt[0] = safe_divide(v0, norm2(comm, v0))
    for j in range(m):
        w = op(vt[j])
        w2, c = cgs2_project(comm, v, w[:, None])
        w2 = w2[:, 0]
        hnorm = norm2(comm, w2)
        hcol = c[:, 0].clone()
        hcol[j + 1] = hnorm
        vt[j + 1] = safe_divide(w2, hnorm)
        h[:, j] = hcol
    return v, h


def lanczos_eigs(op: Operator, v0: torch.Tensor, nev: int,
                 m: int | None = None, *, which: str = "LM",
                 comm: Comm | None = None):
    """Symmetric eigenpairs from a fully reorthogonalized Lanczos run of
    length m (default min(4·nev + 20, n − 1), n the global row count: over
    a group of ranks the sum of their rows): eigh of the symmetrized
    projected matrix. Returns (eigenvalues (nev,), eigenvectors (n, nev))."""
    comm = comm or SerialComm()
    n = v0.shape[0]
    if comm.size > 1:
        n = int(comm.psum(torch.tensor(n, dtype=torch.int64,
                                       device=v0.device)))
    m = m or min(4 * nev + 20, n - 1)
    v, h = arnoldi(op, v0, m, comm=comm)
    t = (h[:m, :] + h[:m, :].T) / 2
    theta, y = torch.linalg.eigh(t)
    if which == "LM":
        idx = torch.argsort(-theta.abs())[:nev]
    elif which == "LA":
        idx = torch.argsort(-theta)[:nev]
    elif which == "SA":
        idx = torch.argsort(theta)[:nev]
    else:
        raise ValueError(f"unknown which={which!r}")
    return theta[idx], v[:, :m] @ y[:, idx]
