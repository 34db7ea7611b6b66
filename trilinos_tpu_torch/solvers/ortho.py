"""Orthogonalization managers.

Counterpart of ``trilinos_tpu/solvers/ortho.py`` (Belos' DGKS, ICGS
(CGS2) and IMGS managers; CholQR/CholQR2 in the role Belos gives TSQR;
Anasazi's SVQB). Every projection is one block inner product
(``mv_trans_mv``) plus one ``psum`` and one rank-k update
(``mv_times_mat_add_mv``); a block is normalised by Cholesky-QR, one
reduction per pass instead of one per column. The GEMMs are
``torch.matmul``/``addmm`` in full float32 (TF32 off) and the small
Cholesky is ``chol_inv_small`` (a CUDA kernel on the card).

The JAX package projects against the whole zero-padded basis because XLA
needs static shapes. Here the ``*_window`` variants read only the basis
prefix holding filled columns, which gives the same coefficients (unfilled
columns are zero) for a fraction of the bytes; the block solver uses them.
A basis may be stored narrower than the block (a bf16 basis for an f32
block): the products then widen it one block of columns at a time.
"""
from __future__ import annotations

import math

import torch

from ..ops import smalldense
from ..ops.blas import local_dot, mv_times_mat_add_mv, mv_trans_mv
from ..parallel.comm import Comm

# Reference default thresholds (BelosDGKSOrthoManager.hpp:99-107).
DGKS_DEP_TOL = 1 / math.sqrt(2.0)
SING_TOL = 10.0  # times eps, for rank detection in normalize


def project_block(comm: Comm, v: torch.Tensor, w: torch.Tensor):
    """One classical-GS pass: c = vᵀw (GEMM + psum), w ← w − v c.

    v: (n, m) basis (unfilled columns zero); w: (n, k). Returns (w_new, c)
    in w's dtype."""
    c = comm.psum(mv_trans_mv(v, w))
    return mv_times_mat_add_mv(-1.0, v, c, 1.0, w), c


def cgs2_project(comm: Comm, v: torch.Tensor, w: torch.Tensor):
    """Iterated CGS (CGS2): two unconditional passes, the ICGS manager's
    default. Returns (w, c_total)."""
    w1, c1 = project_block(comm, v, w)
    w2, c2 = project_block(comm, v, w1)
    return w2, c1 + c2


def _dgks(comm: Comm, w: torch.Tensor, one_pass, dep_tol: float):
    """DGKS around ``one_pass(w) -> (w, c)``: a second pass only when some
    column lost more than dep_tol of its norm (one host read of the test;
    all columns take the second pass together)."""
    norms_before = comm.psum(local_dot(w, w))
    w1, c1 = one_pass(w)
    norms_after = comm.psum(local_dot(w1, w1))
    if bool((norms_after < (dep_tol ** 2) * norms_before).any()):
        w2, c2 = one_pass(w1)
        return w2, c1 + c2
    return w1, c1


def dgks_project(comm: Comm, v: torch.Tensor, w: torch.Tensor,
                 dep_tol: float = DGKS_DEP_TOL):
    """Classical GS with *conditional* reorthogonalization
    (BelosDGKSOrthoManager.hpp:644)."""
    return _dgks(comm, w, lambda u: project_block(comm, v, u), dep_tol)


def mgs_project(comm: Comm, v: torch.Tensor, w: torch.Tensor, n_valid):
    """Modified Gram-Schmidt: one reduction per basis column, over the
    first ``n_valid`` columns (the rest of c stays zero)."""
    m = v.shape[1]
    c = torch.zeros((m, w.shape[1]), dtype=w.dtype, device=w.device)
    for j in range(min(int(n_valid), m)):
        vj = v[:, j].to(w.dtype)
        cj = comm.psum(vj @ w)
        w = w - vj[:, None] * cj[None, :]
        c[j] = cj
    return w, c


def cholqr(comm: Comm, w: torch.Tensor, eps: float | None = None):
    """Cholesky-QR: G = wᵀw (one psum), R = chol(G)ᵀ, Q = w R⁻¹.

    Returns (q, r, rank_ok); rank_ok flags columns whose R diagonal stands
    above the floor. The floor max(SING_TOL·eps·max|G|, tiny) is added to
    G's diagonal so the factor stays finite even for an all-zero panel
    (then q = 0 and rank_ok is False). q = w·L⁻ᵀ is one GEMM with the
    explicit inverse, as in the JAX package: one failed pivot makes every
    column NaN, so callers judge rank-deficient panels by rank_ok."""
    g = comm.psum(mv_trans_mv(w, w))
    eps = eps or torch.finfo(w.dtype).eps
    k = g.shape[0]
    tiny = torch.finfo(w.dtype).tiny
    floor_val = torch.clamp(SING_TOL * eps * g.abs().max(), min=tiny)
    l, linv = smalldense.chol_inv_small(
        g + floor_val * torch.eye(k, dtype=g.dtype, device=g.device))
    r = l.T
    q = mv_times_mat_add_mv(1.0, w, linv.T, 0.0, None)
    rank_ok = torch.diagonal(r) > torch.sqrt(floor_val) * 10
    return q, r, rank_ok


def cholqr2(comm: Comm, w: torch.Tensor):
    """CholQR2: two Cholesky-QR passes, orthogonal to machine precision for
    well-conditioned panels; the block-normalization workhorse."""
    q1, r1, ok1 = cholqr(comm, w)
    q2, r2, ok2 = cholqr(comm, q1)
    return q2, r2 @ r1, ok1 & ok2


def svqb(comm: Comm, w: torch.Tensor):
    """SVQB orthonormalization (Anasazi's SVQB manager): G = wᵀw scaled to
    unit diagonal, G = U Λ Uᵀ, Q = w D⁻¹ U Λ^(−1/2). Returns (q, rank_ok)."""
    g = comm.psum(mv_trans_mv(w, w))
    eps = torch.finfo(w.dtype).eps
    dinv = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(g), min=eps))
    g_s = g * dinv[:, None] * dinv[None, :]
    lam, u = torch.linalg.eigh((g_s + g_s.T) / 2)
    cut = 10 * eps * lam.max()
    rank_ok = lam > cut
    q = (w * dinv[None, :]) @ (u * (1.0 / torch.sqrt(
        torch.maximum(lam, cut)))[None, :])
    return q, rank_ok


def project_block_window(comm: Comm, v: torch.Tensor, w: torch.Tensor,
                         n_active, chunk: int = 8):
    """One classical-GS pass that reads only the basis prefix holding the
    ``n_active`` filled columns, rounded up to a multiple of ``chunk``.
    Sound only under the zero-padded-basis invariant for the columns inside
    that last chunk. Returns (w2, c) with c zero-padded to (m, k), the
    coefficient block of the full-basis pass."""
    n, mp = v.shape
    if mp % chunk:
        raise ValueError(f"basis columns {mp} not a multiple of chunk {chunk}")
    c = torch.zeros((mp, w.shape[1]), dtype=w.dtype, device=w.device)
    n_active = int(n_active)
    if n_active <= 0:
        return w, c
    ncol = min(-(-n_active // chunk), mp // chunk) * chunk
    w2, c[:ncol] = project_block(comm, v[:, :ncol], w)
    return w2, c


def cgs2_project_window(comm: Comm, v: torch.Tensor, w: torch.Tensor,
                        n_active, chunk: int = 8):
    """CGS2 (two unconditional passes) over the active window only."""
    w1, c1 = project_block_window(comm, v, w, n_active, chunk)
    w2, c2 = project_block_window(comm, v, w1, n_active, chunk)
    return w2, c1 + c2


def dgks_project_window(comm: Comm, v: torch.Tensor, w: torch.Tensor,
                        n_active, chunk: int = 8,
                        dep_tol: float = DGKS_DEP_TOL):
    """DGKS (conditional second pass) over the active window only."""
    return _dgks(comm, w, lambda u: project_block_window(
        comm, v, u, n_active, chunk), dep_tol)


def project_and_normalize(comm: Comm, v: torch.Tensor, w: torch.Tensor,
                          method: str = "CGS2"):
    """Belos-style projectAndNormalize: orthogonalize block w against basis
    v, then orthonormalize within the block. Returns (q, c, r, rank_ok)
    with w ≈ v c + q r and qᵀq = I. ``method`` ∈ {"CGS2", "DGKS", "MGS1",
    "IMGS"} (MGS1: one MGS pass over all columns of v; IMGS: two)."""
    if method == "CGS2":
        w2, c = cgs2_project(comm, v, w)
    elif method == "DGKS":
        w2, c = dgks_project(comm, v, w)
    elif method == "MGS1":
        w2, c = mgs_project(comm, v, w, v.shape[1])
    elif method == "IMGS":
        w1, c1 = mgs_project(comm, v, w, v.shape[1])
        w2, c2 = mgs_project(comm, v, w1, v.shape[1])
        c = c1 + c2
    else:
        raise ValueError(f"unknown ortho method {method!r}")
    q, r, rank_ok = cholqr2(comm, w2)
    return q, c, r, rank_ok


def valid_methods() -> tuple[str, ...]:
    """Names mirroring the reference's "Orthogonalization" parameter
    choices (BelosBlockGmresSolMgr.hpp:150-158: DGKS / ICGS / IMGS)."""
    return ("CGS2", "DGKS", "MGS1", "ICGS", "IMGS")


def resolve_method(name: str) -> str:
    """Map reference spellings to local implementations (ICGS is CGS2,
    MGS is the single-pass MGS1, IMGS two MGS passes)."""
    alias = {"ICGS": "CGS2", "IMGS": "IMGS", "DGKS": "DGKS", "CGS2": "CGS2",
             "MGS1": "MGS1", "MGS": "MGS1"}
    try:
        return alias[name.upper()]
    except KeyError:
        raise ValueError(f"unknown orthogonalization {name!r}; valid: "
                         f"{valid_methods()}") from None


def masked_lstsq(h: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Least squares min ‖rhs − H y‖ for an (m+1, m) Hessenberg, with
    numerically dependent columns masked to y = 0 (the happy-breakdown
    guard: a unit diagonal and zero rhs decouple them exactly, because R is
    upper triangular)."""
    mk = h.shape[1]
    q_h, r_h = torch.linalg.qr(h)
    diag = torch.diagonal(r_h).abs()
    good = diag > 10 * torch.finfo(h.dtype).eps * diag.max()
    eye = torch.eye(mk, dtype=h.dtype, device=h.device)
    r_m = torch.where(~good[None, :] | ~good[:, None], eye, r_h)
    rhs2 = rhs[:, None] if rhs.ndim == 1 else rhs
    qtr = torch.where(good[:, None], q_h.T @ rhs2, 0.0)
    y = torch.linalg.solve_triangular(r_m, qtr, upper=True)
    y = torch.where(good[:, None], y, 0.0)
    return y[:, 0] if rhs.ndim == 1 else y


# -- pseudo-block passes: k independent bases, one per right-hand side ------
# v is (k, p, n) (basis vectors as rows, one basis per RHS) and w is (k, n);
# each pass is one batched GEMM per product, c is (k, p). The caller widens
# a narrower basis to w's dtype first.


def project_rows(comm: Comm, v: torch.Tensor, w: torch.Tensor):
    """One classical-GS pass per basis: c_i = v_iᵀ w_i, w_i ← w_i − v_i c_i."""
    c = comm.psum(torch.bmm(v, w[:, :, None]))
    w2 = torch.baddbmm(w[:, :, None], v.transpose(1, 2), c, alpha=-1)
    return w2[:, :, 0], c[:, :, 0]


def cgs2_project_rows(comm: Comm, v: torch.Tensor, w: torch.Tensor):
    """CGS2 per basis: two unconditional passes. Returns (w, c_total)."""
    w1, c1 = project_rows(comm, v, w)
    w2, c2 = project_rows(comm, v, w1)
    return w2, c1 + c2


def dgks_project_rows(comm: Comm, v: torch.Tensor, w: torch.Tensor,
                      dep_tol: float = DGKS_DEP_TOL):
    """DGKS per basis: each RHS takes the second pass only if its vector
    lost more than dep_tol of its norm. Both passes run for all and each
    row keeps its own (no host read)."""
    norms_before = comm.psum((w * w).sum(dim=1))
    w1, c1 = project_rows(comm, v, w)
    norms_after = comm.psum((w1 * w1).sum(dim=1))
    need = (norms_after < (dep_tol ** 2) * norms_before)[:, None]
    w2, c2 = project_rows(comm, v, w1)
    return torch.where(need, w2, w1), torch.where(need, c1 + c2, c1)


def mgs_project_rows(comm: Comm, v: torch.Tensor, w: torch.Tensor,
                     passes: int = 1):
    """Modified Gram-Schmidt per basis over all p columns of v: one
    reduction per basis vector and pass (IMGS: passes=2)."""
    c = torch.zeros(v.shape[:2], dtype=w.dtype, device=w.device)
    for _ in range(passes):
        for j in range(v.shape[1]):
            vj = v[:, j].to(w.dtype)
            cj = comm.psum((vj * w).sum(dim=1))
            w = w - vj * cj[:, None]
            c[:, j] += cj
    return w, c
