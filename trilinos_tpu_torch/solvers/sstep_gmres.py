"""s-step (communication-avoiding) GMRES.

Counterpart of ``trilinos_tpu/solvers/sstep_gmres.py`` (the analogue of
Belos' Tpetra GmresSstep): each block of s basis vectors is generated by a
matrix-powers recurrence and orthogonalized en bloc, with one CGS2 block
projection and one CholQR2, so a cycle of m = s·t_blocks vectors needs 4
reductions per s vectors instead of about 3 per vector.

Bookkeeping: each block produces W = [w_1..w_s] from w_0 = q (the last
basis vector) by w_k = α_k·A w_{k−1} + β_k·w_{k−1} + γ_k·w_{k−2}
(monomial: α = 1/σ, β = γ = 0; Newton: shifted, conjugate pairs fused
into real quadratic stages). Both sides of A·[w_0..w_{s−1}] = [w_0..w_s]·B
are expressed in the final orthonormal basis, so GMRES reduces to one
small masked least-squares problem per cycle.

The basis is stored one vector per row, (m+1, n), so the working vector
is contiguous for the operator; ``v`` is its (n, m+1) transposed view, the
JAX package's layout, and the block projection reads only the filled
prefix of it (the ``*_window`` pass; the JAX package's full pass reads
zero columns that add nothing to c). JAX's ``lax.while_loop`` becomes a
Python loop with one host read of the true residual per cycle.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..device import resolve_device
from ..ops.blas import mv_times_mat_add_mv
from ..ops.dispatch import use_kernel
from ..ops.stencil_op import StencilOp
from ..ops.stencil_poly import MAX_STAGES, stencil_powers_apply
from ..parallel.comm import Comm, SerialComm, norm2
from .base import (Operator, SolveResult, identity_prec, rhs_norm_scale,
                   safe_divide)
from .ortho import cgs2_project_window, cholqr2, masked_lstsq


def leja_order(vals) -> np.ndarray:
    """Modified Leja ordering (host side): start at the largest modulus,
    then greedily maximize Π|z − chosen| (as a sum of logs); a complex value
    is followed at once by its conjugate so the Newton basis can fuse the
    pair into a real quadratic stage."""
    remaining = list(np.asarray(vals, complex))
    out: list[complex] = []
    while remaining:
        if not out:
            idx = int(np.argmax(np.abs(remaining)))
        else:
            chosen = np.asarray(out)
            score = [float(np.sum(np.log(
                np.maximum(np.abs(chosen - z), 1e-300))))
                for z in remaining]
            idx = int(np.argmax(score))
        z = remaining.pop(idx)
        out.append(z)
        if abs(z.imag) > 1e-12 * max(1.0, abs(z)) and remaining:
            d = [abs(w - np.conj(z)) for w in remaining]
            j = int(np.argmin(d))
            if d[j] <= 1e-8 * max(1.0, abs(z)):
                out.append(remaining.pop(j))
    return np.asarray(out)


def ritz_shifts(op: Operator, b: torch.Tensor, s: int,
                comm: Comm | None = None) -> np.ndarray:
    """s Leja-ordered Ritz values from an s-step Arnoldi run on b: the
    Newton-basis shifts (host-side set-up)."""
    from ..eigen.lanczos import arnoldi  # eigen imports the solvers package

    _, h = arnoldi(op, b, s, comm=comm)
    hm = h[:s, :s].cpu().numpy()
    return leja_order(np.linalg.eigvals(hm))


def estimate_opnorm(apply, n: int, dtype, comm: Comm | None = None,
                    iters: int = 3, seed: int = 0, device=None) -> float:
    """Crude ‖A‖₂ estimate by a few power iterations from a seeded normal
    vector of length n on ``device`` (``None`` means the CUDA card)."""
    comm = comm or SerialComm()
    v = torch.as_tensor(np.random.default_rng(seed).standard_normal(n)).to(
        device=resolve_device(device), dtype=dtype)
    v = v / norm2(comm, v)
    sig = 1.0
    for _ in range(iters):
        w = apply(v)
        sig = norm2(comm, w)
        v = safe_divide(w, sig)
    return max(float(sig), 1e-30)


def newton_basis_stages(shifts, sigma: float):
    """(α, β, γ) per stage of the σ-scaled Newton basis
    w_k = (A − λ_k) w_{k−1} / σ. An adjacent conjugate pair (as
    :func:`leja_order` gives it) becomes a real quadratic: the pair's
    second stage computes w_{k+1} = ((A − a) w_k + (b²/σ) w_{k−1}) / σ, so
    σ² w_{k+1} = (A − λ)(A − λ̄) w_{k−1}."""
    inv = 1.0 / float(sigma)
    shifts = np.asarray(shifts, complex)
    out: list[tuple[float, float, float]] = []
    i = 0
    while i < len(shifts):
        z = shifts[i]
        if abs(z.imag) <= 1e-12 * max(1.0, abs(z)):
            out.append((inv, -z.real * inv, 0.0))
            i += 1
            continue
        if (i + 1 >= len(shifts)
                or abs(shifts[i + 1] - np.conj(z))
                > 1e-8 * max(1.0, abs(z))):
            raise ValueError(
                "complex shifts must come in adjacent conjugate pairs "
                "(order them with leja_order)")
        a, bb = z.real, abs(z.imag)
        out.append((inv, -a * inv, 0.0))
        out.append((inv, -a * inv, (bb * bb) * inv * inv))
        i += 2
    return out


def sstep_gmres(op: Operator, b: torch.Tensor,
                x0: torch.Tensor | None = None, *, s: int = 4,
                t_blocks: int = 8, max_restarts: int = 20,
                rtol: float = 1e-8, atol: float = 0.0,
                sigma: float | None = None, prec: Operator | None = None,
                comm: Comm | None = None, basis_impl: str = "auto",
                powers_fn: Callable | None = None, shifts=None,
                basis_dtype=None) -> SolveResult:
    """Restarted s-step GMRES, m = s·t_blocks basis vectors per cycle.

    basis_impl: how each block W is generated. ``"loop"``: s operator
    applies (any operator, any preconditioner). ``"fused"``: one
    ``stencil_powers_apply`` (an unpreconditioned ``StencilOp``; the CUDA
    kernel on the card, its plain version on the CPU). ``"auto"``: fused
    for an unpreconditioned ``StencilOp`` on a CUDA tensor, else loop.

    shifts: s Newton-basis shifts (``ritz_shifts``), complex ones in
    adjacent conjugate pairs, in place of the monomial basis.

    powers_fn: ``powers_fn(q, sigma) -> (n, s)`` overriding basis_impl; it
    must produce the loop basis's recurrence and needs an explicit sigma.

    basis_dtype (e.g. ``torch.bfloat16``): store the orthonormal basis
    narrower; the block W, the CholQR panels and the small matrices stay
    in b's dtype. ``iters`` counts basis vectors: cycles·m."""
    comm = comm or SerialComm()
    M = prec or identity_prec
    x = torch.zeros_like(b) if x0 is None else x0
    n = b.shape[0]
    m = s * t_blocks
    dtype = b.dtype
    bdt = basis_dtype or dtype

    def opM(v):
        return op(M(v))

    if basis_impl not in ("auto", "loop", "fused"):
        raise ValueError(f"unknown basis_impl {basis_impl!r}")
    if powers_fn is not None and sigma is None:
        raise ValueError("powers_fn requires an explicit sigma")
    if powers_fn is not None and prec is not None:
        raise ValueError("powers_fn generates an unpreconditioned "
                         "basis; prec cannot be combined with it")
    if sigma is None:
        sigma = estimate_opnorm(opM, n, dtype, comm, device=b.device)
    if shifts is not None:
        stage_coeffs = newton_basis_stages(shifts, sigma)
        if len(stage_coeffs) != s:
            raise ValueError(f"need exactly s={s} shifts")
    else:
        stage_coeffs = [(1.0 / sigma, 0.0, 0.0)] * s

    fusable = (powers_fn is None and prec is None
               and isinstance(op, StencilOp) and n == op.n_rows_pad
               and 1 <= s <= MAX_STAGES)
    if basis_impl == "fused" and not fusable:
        raise ValueError("basis_impl='fused' needs an unpreconditioned "
                         "StencilOp and 1 ≤ s ≤ 8")
    if fusable and (basis_impl == "fused" or (
            basis_impl == "auto" and use_kernel(b))):
        stages4 = tuple((a, bt, g, 0.0) for a, bt, g in stage_coeffs)
        pad = (torch.arange(n, device=b.device) < op.n_rows
               if op.n_rows_pad > op.n_rows else None)

        def powers_fn(q, sig):
            u = stencil_powers_apply(op, stages4, q)  # (s, n)
            if pad is not None:
                # the loop basis has zero pad rows; the kernel's pad rows
                # carry q's
                u = torch.where(pad[None, :], u, 0.0)
            return u.T

    alphas = [a for a, _, _ in stage_coeffs]
    betas_c = torch.tensor([bt for _, bt, _ in stage_coeffs], dtype=dtype,
                           device=b.device)
    gammas_c = torch.tensor([g for _, _, g in stage_coeffs], dtype=dtype,
                            device=b.device)
    inv_alpha_c = torch.tensor([1.0 / a for a in alphas], dtype=dtype,
                               device=b.device)

    bnorm = norm2(comm, b)
    tol = rhs_norm_scale(bnorm, rtol, atol)
    # every cycle writes column 0 and each block the next s columns before
    # any of them is read, so the basis is allocated once and never zeroed
    vt = torch.empty((m + 1, n), dtype=bdt, device=b.device)
    v = vt.T

    def block_powers(q):
        """W = [w_1..w_s] as an (n, s) view of an (s, n) stack."""
        if powers_fn is not None:
            return powers_fn(q, sigma)
        ws, w_prev, w_prev2 = [], q, torch.zeros_like(q)
        for i in range(s):
            w = (alphas[i] * opM(w_prev) + betas_c[i] * w_prev
                 + gammas_c[i] * w_prev2)
            ws.append(w)
            w_prev, w_prev2 = w, w_prev
        return torch.stack(ws).T

    def cycle(x):
        r = b - op(x)
        beta = norm2(comm, r)
        vt[0] = safe_divide(r, beta).to(bdt)
        ex = torch.zeros((m + 1, m), dtype=dtype, device=b.device)
        fy = torch.zeros((m + 1, m), dtype=dtype, device=b.device)
        for blk in range(t_blocks):
            j0 = blk * s
            wmat = block_powers(vt[j0].to(dtype))
            # W = V C + Q R against the filled columns 0..j0 only: the
            # unfilled rows of c stay zero, as the full pass would give
            w2, c_full = cgs2_project_window(comm, v, wmat, j0 + 1, chunk=1)
            q_new, r_small, _ = cholqr2(comm, w2)
            vt[j0 + 1:j0 + 1 + s] = q_new.T.to(bdt)
            # global coordinates of w_k: C[:, k] + R[:, k] at j0+1..j0+s
            g = c_full
            g[j0 + 1:j0 + 1 + s] += r_small
            # X columns j0..j0+s−1: [e_{j0}, g_1..g_{s−1}]
            e_col = torch.zeros((m + 1, 1), dtype=dtype, device=b.device)
            e_col[j0, 0] = 1.0
            x_blk = torch.cat([e_col, g[:, :s - 1]], dim=1)
            ex[:, j0:j0 + s] = x_blk
            # Y columns from the recurrence read backwards:
            # A w_{k−1} = (w_k − β_k w_{k−1} − γ_k w_{k−2}) / α_k
            g_prev2 = torch.cat([torch.zeros_like(e_col), x_blk[:, :s - 1]],
                                dim=1)
            fy[:, j0:j0 + s] = ((g - x_blk * betas_c[None, :]
                                 - g_prev2 * gammas_c[None, :])
                                * inv_alpha_c[None, :])
        e1 = torch.zeros(m + 1, dtype=dtype, device=b.device)
        e1[0] = beta
        # masked least squares: a residual captured mid-cycle leaves
        # rank-deficient trailing columns in fy
        y = masked_lstsq(fy, e1)
        upd = mv_times_mat_add_mv(1.0, v, (ex @ y)[:, None], 0.0, None)
        return x + M(upd[:, 0])

    def res_norm(x):
        return norm2(comm, b - op(x))

    rn = res_norm(x)
    cycles = 0
    while cycles < max_restarts + 1 and bool(rn > tol):
        x = cycle(x)
        cycles += 1
        rn = res_norm(x)
    return SolveResult(x=x, iters=cycles * m, resnorm=rn, converged=rn <= tol)
