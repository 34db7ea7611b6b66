"""Block Krylov–Schur eigensolver with thick restarts.

Counterpart of ``trilinos_tpu/eigen/krylov_schur.py``
(Anasazi::BlockKrylovSchur, AnasaziBlockKrylovSchurSolMgr.hpp): block
Arnoldi expansion, Schur form of the projected matrix, and Stewart's
Krylov–Schur restart keeping the wanted Ritz block. From
A V_m = V_m H + V_b B E_mᵀ, order T = Qᵀ H Q so the wanted Ritz values
lead and keep k columns: A (V_m Q_k) = (V_m Q_k) T_k + V_b (B Q[m−nb:m, :k]).

The split is the reference's: the block Arnoldi steps (block apply, CGS2
projection against the zero-padded basis, CholQR2 panel) run on the
basis's device with no host read; the (m × m) Schur form, Ritz ordering
and restart assembly run in numpy/scipy on the host once a restart, from H
alone. The basis never leaves the device: the restart's V_m Q_k and the
final Ritz vectors V_m z are products on the device (complex z as its real
and imaginary parts), and only H, m × m, is read back.

Also here: the M-metric CholQR helpers and the expansion-block quality
filter the Davidson family shares.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.linalg as sla
import torch

from ..device import resolve_device, torch_dtype
from ..ops import smalldense
from ..ops.blas import local_dot, mv_trans_mv
from ..parallel.comm import Comm, SerialComm
from ..solvers.base import Operator
from ..solvers.ortho import cgs2_project, cholqr2


@dataclasses.dataclass
class EigsResult:
    eigenvalues: np.ndarray  # (nev,) complex (real for symmetric)
    eigenvectors: torch.Tensor  # (n, nev), on the solve's device
    resnorms: np.ndarray  # (nev,) Ritz residual estimates
    iters: int  # Arnoldi (column) steps performed
    converged: bool


def _host(t: torch.Tensor) -> np.ndarray:
    """A small device tensor as a host array (its dtype kept)."""
    return t.detach().cpu().numpy()


def _contiguous(fn):
    """``fn`` applied to a contiguous copy of a column slice (the kernels
    take row-major blocks); None stays None."""
    if fn is None:
        return None
    return lambda v: fn(v.contiguous())


def _global_rows(comm: Comm, n: int, device) -> int:
    """The row count the basis limits are taken from: ``n`` on one rank;
    over a group of ranks, each passing its local row count, their sum,
    the global size that the JAX package's drivers pass as ``n``."""
    if comm.size == 1:
        return n
    return int(comm.psum(torch.tensor(n, dtype=torch.int64,
                                      device=resolve_device(device))))


def _start_block(rng, n, width, dtype, device):
    """``rng`` standard normals (n, width), drawn on the host as the JAX
    package draws them and placed on ``device`` (``None``: the CUDA
    card)."""
    host = rng.standard_normal((n, width))
    return torch.as_tensor(host, dtype=dtype, device=resolve_device(device))


def _extend(op, comm, v, h, k, m, nb):
    """Block Arnoldi steps k/nb .. m/nb − 1 on (V (n, m+nb), H (m+nb, m)),
    in place."""
    for jb in range(k // nb, m // nb):
        j = jb * nb
        vj = v[:, j:j + nb]
        w = op(vj) if nb > 1 else op(vj[:, 0])[:, None]
        w2, c = cgs2_project(comm, v, w)
        q, r_small, _ = cholqr2(comm, w2)
        c[j + nb:j + 2 * nb] = r_small
        v[:, j + nb:j + 2 * nb] = q
        h[:, j:j + nb] = c


def _mproject(comm, v, vm, w):
    """One classical-GS pass in the M inner product: c = (MV)ᵀw."""
    c = comm.psum(mv_trans_mv(vm, w))
    return w - v @ c, c


def _mcholqr(comm, m_op, w):
    """CholQR in the M metric: G = wᵀMw, Q = w R⁻¹ with QᵀMQ = I (one
    small L⁻¹ and two GEMMs). Returns (q, mq, r)."""
    mw = m_op(w)
    g = comm.psum(mv_trans_mv(w, mw))
    k = g.shape[0]
    eps = torch.finfo(w.dtype).eps
    floor = 10.0 * eps * torch.clamp(g.abs().max(), min=eps)
    l, linv = smalldense.chol_inv_small((g + g.T) / 2 + floor * torch.eye(
        k, dtype=g.dtype, device=g.device))
    rinv = linv.T
    return w @ rinv, mw @ rinv, l.T


def _mortho_block(comm, m_op, v, vm, w):
    """M-orthonormalization of an expansion block against a basis: CGS2
    in the M metric with every column rescaled to unit M-norm between the
    passes (DGKS-style renormalization, BelosDGKSOrthoManager.hpp:99-107),
    so a cancellation-dominated column re-enters the next pass as an
    honest unit vector. Returns (q, mq) with qᵀMq ≈ I."""
    tiny = torch.finfo(w.dtype).tiny

    def renorm(x, mx):
        d = comm.psum(local_dot(x, mx))
        inv = 1.0 / torch.sqrt(torch.clamp(d, min=tiny))
        return x * inv[None, :], mx * inv[None, :]

    w, _ = renorm(w, m_op(w))
    w, _ = _mproject(comm, v, vm, w)
    q, mq, _ = _mcholqr(comm, m_op, w)
    w, _ = renorm(q, mq)
    w, _ = _mproject(comm, v, vm, w)
    q, mq, _ = _mcholqr(comm, m_op, w)
    return q, mq


def _select_expansion_columns(b, cmax, *, corr_tol=2e-3, basis_tol=2e-3):
    """Host-side quality filter for an M-orthonormalized expansion block.

    ``b``: the block's true M-Gram qᵀMq (nb × nb); ``cmax``: per-column
    max |(MS)ᵀq| against the basis. Keeps column j iff its M-norm² is at
    least 0.25, its cross-Gram against the basis is below ``basis_tol``
    and its correlation with every column kept before it is below
    ``corr_tol`` (greedy). Returns (kept indices, per-column 1/√(M-norm²))."""
    b = np.asarray(b)
    cmax = np.asarray(cmax)
    d = np.diag(b)
    kept = []
    for j in range(b.shape[0]):
        if not np.isfinite(d[j]) or d[j] < 0.25:
            continue
        if cmax[j] > basis_tol * np.sqrt(d[j]):
            continue
        if any(abs(b[i, j]) / np.sqrt(d[i] * d[j]) > corr_tol
               for i in kept):
            continue
        kept.append(j)
    return (np.asarray(kept, dtype=int),
            1.0 / np.sqrt(np.maximum(d, 1e-300)))


def _filter_rescale_block(q, mq, bq, cmax):
    """Keep the healthy columns of an M-orthonormalized expansion block,
    rescaled to unit M-norm. Returns (q, mq), or None when every column is
    degenerate (the caller stops: honest stagnation)."""
    good, colscale = _select_expansion_columns(_host(bq), _host(cmax))
    if len(good) == 0:
        return None
    if len(good) == bq.shape[0] and np.allclose(colscale, 1.0, atol=1e-3):
        return q, mq  # healthy block: no gather
    idx = torch.as_tensor(good, device=q.device)
    inv = torch.as_tensor(colscale[good], dtype=q.dtype,
                          device=q.device)[None, :]
    return (torch.index_select(q, 1, idx) * inv,
            torch.index_select(mq, 1, idx) * inv)


def _mcholqr2(comm, m_op, w):
    """Two M-metric CholQR passes: (q, mq) with qᵀMq ≈ I."""
    q, mq, _ = _mcholqr(comm, m_op, w)
    q, mq, _ = _mcholqr(comm, m_op, q)
    return q, mq


def _expansion_quality(comm, q, mq, ms_, k):
    """The true M-Gram qᵀMq and the worst cross-Gram entry per column
    against the basis prefix (for ``_select_expansion_columns``)."""
    bq = comm.psum(mv_trans_mv(q, mq))
    cmax = comm.psum(mv_trans_mv(ms_[:, :k], q)).abs().amax(dim=0)
    return bq, cmax


def _extend_gen(op, m_op, m_solve, comm, v, vm, h, k, m, nb):
    """Generalized block-Lanczos steps in the M inner product on
    K = M⁻¹A (``m_solve`` approximating M⁻¹): two M-metric projections
    against the M-orthonormal basis through its cached M·V, then an
    M-metric CholQR panel. K·V_m = V_{m+nb}·H with VᵀMV = I; in place."""
    for jb in range(k // nb, m // nb):
        j = jb * nb
        vj = v[:, j:j + nb]
        av = op(vj) if nb > 1 else op(vj[:, 0])[:, None]
        w = m_solve(av)
        w, c1 = _mproject(comm, v, vm, w)
        w, c2 = _mproject(comm, v, vm, w)
        q, mq, r_small = _mcholqr(comm, m_op, w)
        hcol = c1 + c2
        hcol[j + nb:j + 2 * nb] = r_small
        v[:, j + nb:j + 2 * nb] = q
        vm[:, j + nb:j + 2 * nb] = mq
        h[:, j:j + nb] = hcol


def _crit(w, which):
    if which == "LM":
        return np.abs(w)
    if which == "SM":
        return -np.abs(w)
    if which == "LR":
        return np.real(w)
    if which == "SR":
        return -np.real(w)
    raise ValueError(f"unknown which={which!r}")


def _ordschur(hm: np.ndarray, which: str, keep: int):
    """Ordered real Schur form with the ``keep`` most-wanted eigenvalues
    in the leading block (LAPACK trsen through scipy.schur(sort=...)); the
    sort predicate is a threshold on the selection criterion."""
    w_all = sla.eigvals(hm)
    vals = _crit(w_all, which)
    cutoff = np.sort(vals)[-keep]
    eps = 1e-12 * max(1.0, float(np.abs(vals).max()))

    def sort_fn(re, im):
        return bool(_crit(re + 1j * im, which) >= cutoff - eps)

    t_mat, q, _ = sla.schur(hm, output="real", sort=sort_fn)
    return t_mat, q, sla.eigvals(t_mat)


def _cg_m_solve(mass, comm, iters):
    """A fixed ``iters``-step unpreconditioned CG on M, column by column:
    the default M⁻¹ of the generalized recurrence (no host read)."""
    def m_solve(rhs):
        x = torch.zeros_like(rhs)
        r = rhs
        p = r
        rr = comm.psum(local_dot(r, r))
        for _ in range(iters):
            ap = mass(p)
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

    return m_solve


def _ritz_vectors(comm: Comm, vm_: torch.Tensor,
                  z: np.ndarray) -> torch.Tensor:
    """V_m z on V's device in float64, columns scaled to unit norm over
    every rank's rows; a complex z as its real and imaginary parts (two
    real GEMMs)."""
    v64 = vm_.to(torch.float64)
    zr = torch.as_tensor(np.ascontiguousarray(z.real), device=v64.device)
    xr = v64 @ zr
    sq = (xr * xr).sum(dim=0, keepdim=True)
    if not np.iscomplexobj(z):
        return xr / torch.sqrt(comm.psum(sq))
    zi = torch.as_tensor(np.ascontiguousarray(z.imag), device=v64.device)
    xi = v64 @ zi
    nrm = torch.sqrt(comm.psum(sq + (xi * xi).sum(dim=0, keepdim=True)))
    return torch.complex(xr / nrm, xi / nrm)


def block_krylov_schur(op: Operator, n: int, nev: int, *,
                       m: int | None = None, nb: int = 1,
                       which: str = "LM", tol: float = 1e-8,
                       max_restarts: int = 50, symmetric: bool = False,
                       v0: torch.Tensor | None = None,
                       comm: Comm | None = None,
                       mass: Operator | None = None,
                       m_solve: Operator | None = None,
                       m_solve_iters: int = 30,
                       dtype=torch.float64, device=None) -> EigsResult:
    """``nev`` eigenpairs of ``op`` on length-n vectors (for nb > 1 the
    operator takes (n, nb) blocks). which: LM / SM / LR / SR;
    ``symmetric=True`` uses eigh for the projected problem (thick-restart
    block Lanczos).

    ``mass``: an SPD mass operator for the pencil A x = λ M x: the
    recurrence runs on K = M⁻¹A in the M inner product, M⁻¹ by
    ``m_solve`` (default: ``m_solve_iters`` steps of unpreconditioned CG
    on M). ``v0``: a start vector or block; without it the start block is
    ``default_rng(42)`` normals placed on ``device`` (``None``: the CUDA
    card). Eigenvectors come back on the basis's device, float64 (complex
    for a nonsymmetric problem's complex pairs)."""
    comm = comm or SerialComm()
    dtype = torch_dtype(dtype)
    op, mass = _contiguous(op), _contiguous(mass)
    n_all = _global_rows(comm, n, v0.device if v0 is not None else device)
    m = m or min(max(2 * nev + 12, 20), n_all - nb)
    m = (m // nb) * nb
    keep_target = min(nev + max(nev // 2, 4), m - 2 * nb)
    keep_target = max((keep_target // nb) * nb, nb)
    if mass is not None and m_solve is None:
        m_solve = _cg_m_solve(mass, comm, m_solve_iters)
    m_solve = _contiguous(m_solve)

    rng = np.random.default_rng(42)
    if v0 is None:
        v0 = _start_block(rng, n, nb, dtype, device)
    elif v0.ndim == 1:
        v0 = (torch.cat([v0[:, None].to(dtype), torch.as_tensor(
            rng.standard_normal((n, nb - 1)), dtype=dtype,
            device=v0.device)], dim=1) if nb > 1 else v0[:, None])
    v0 = v0.to(dtype)
    dev = v0.device
    v = torch.zeros((n, m + nb), dtype=dtype, device=dev)
    vm = None
    if mass is None:
        v[:, :nb] = cholqr2(comm, v0)[0]
    else:
        vm = torch.zeros_like(v)
        v[:, :nb], vm[:, :nb] = _mcholqr2(comm, mass, v0)
    h = torch.zeros((m + nb, m), dtype=dtype, device=dev)
    k = 0
    total_steps = 0
    res = np.full(nev, np.inf)
    converged = False

    for restart in range(max_restarts + 1):
        if mass is None:
            _extend(op, comm, v, h, k, m, nb)
        else:
            _extend_gen(op, mass, m_solve, comm, v, vm, h, k, m, nb)
        total_steps += (m - k)
        hn = _host(h).astype(np.float64)
        hm = hn[:m, :m]
        b_blk = hn[m:m + nb, m - nb:m]  # residual coupling block

        if symmetric:
            theta_all, q = np.linalg.eigh((hm + hm.T) / 2)
            order = np.argsort(-_crit(theta_all, which))
            q = q[:, order]
            theta_sorted = theta_all[order]
            t_mat = np.diag(theta_sorted)
        else:
            t_mat, q, theta_sorted = _ordschur(hm, which, keep_target)

        # Ritz residuals of the leading nev: ||B Q[m-nb:m, j]||
        coup = b_blk @ q[m - nb:m, :]
        res = np.linalg.norm(coup[:, :nev].reshape(nb, nev), axis=0)
        scale = np.maximum(np.abs(theta_sorted[:nev]), 1e-30)
        converged = bool((res <= tol * scale).all())
        if converged or restart == max_restarts:
            break

        # thick restart: keep a multiple of nb; don't split a 2x2 block
        keep = keep_target
        if not symmetric and keep < m and t_mat[keep, keep - 1] != 0:
            keep += nb
        qk = torch.as_tensor(q[:, :keep], dtype=dtype, device=dev)
        v_new = torch.zeros_like(v)
        v_new[:, :keep] = v[:, :m] @ qk
        v_new[:, keep:keep + nb] = v[:, m:m + nb]
        v = v_new
        if mass is not None:
            vm_new = torch.zeros_like(vm)
            vm_new[:, :keep] = vm[:, :m] @ qk
            vm_new[:, keep:keep + nb] = vm[:, m:m + nb]
            vm = vm_new
        h_new = np.zeros_like(hn)
        h_new[:keep, :keep] = t_mat[:keep, :keep]
        h_new[keep:keep + nb, :keep] = coup[:, :keep]
        h = torch.as_tensor(h_new, dtype=dtype, device=dev)
        k = keep

    # eigenpairs from the final projected matrix
    if symmetric:
        theta_fin, z_all = np.linalg.eigh((hn[:m, :m] + hn[:m, :m].T) / 2)
        w_all = theta_fin.astype(complex)
    else:
        w_all, z_all = np.linalg.eig(hn[:m, :m])
    order = np.argsort(-_crit(w_all, which))[:nev]
    w_small = w_all[order]
    x = _ritz_vectors(comm, v[:, :m], z_all[:, order])
    if symmetric:
        w_small = w_small.real
    return EigsResult(eigenvalues=w_small, eigenvectors=x,
                      resnorms=res, iters=total_steps, converged=converged)
