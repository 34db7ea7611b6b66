"""GMRES family: restarted GMRES(m), pseudo-block GMRES, flexible GMRES.

Counterpart of ``trilinos_tpu/solvers/gmres.py`` (Belos' GMRES iteration,
restart manager, pseudo-block and flexible variants), right-preconditioned,
with the reference's options: CGS2, DGKS, MGS1 or IMGS projection,
``window_chunk``, ``condest``, ``history``, ``stop``, ``compensated`` norms
and a narrower ``basis_dtype``; restarts gated on the true residual and the
stall guard.

Pseudo-block GMRES. The JAX package ``vmap``s the one-column solver, so
every column keeps its own Krylov space, Hessenberg, rotations, restarts
and stall guard, and a column whose inner or outer loop has ended freezes
while the others go on. Here the columns run together in batched torch:

* the basis is (k, m+1, n), one basis per column with its vectors as rows,
  and working vectors are (k, n); the operator and preconditioner see one
  (n, k) block (or the (n,) vector of a one-column solve);
* each projection is one batched GEMM per product over the filled prefix
  of the basis (the JAX package's zero-padded columns add nothing to the
  coefficients); ``window_chunk`` rounds that prefix up to a multiple of
  the chunk, as the reference's windowed pass does;
* the small state (Hessenberg column, Givens rotations, g, the
  back-substitution, condest, history, the stop tests) lives on the host in
  b's dtype, one array row per column: each Arnoldi step reads one (k,
  p + 1) tensor of coefficients and norms, and nothing else, back from the
  device. A frozen column's state is simply not updated, its new basis
  vectors are written as zeros, and its x and residual are kept by
  ``torch.where``.

Each column's x, iteration count and residual are those of a one-column
solve of that column; ``iters`` is the largest over the columns.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.compensated import comp_dot, psum_ff
from ..parallel.comm import Comm, SerialComm
from .base import Operator, SolveResult, identity_prec
from .ortho import (cgs2_project_rows, dgks_project_rows, mgs_project_rows,
                    resolve_method)
from .status import SolverState

# a cycle that fails to cut the true residual by this factor ends the solve
# (Belos' ImpResNorm loss-of-accuracy status)
STALL_RATIO = 1.0 - 1.0 / 1024.0

# -- layout: (n,) or (n, k) multivectors <-> (k, n) rows ---------------------


def to_rows(b: torch.Tensor) -> torch.Tensor:
    """(n,) → (1, n); (n, k) → (k, n), contiguous."""
    return b[None] if b.ndim == 1 else b.T.contiguous()


def from_rows(t: torch.Tensor, one_d: bool) -> torch.Tensor:
    return t[0] if one_d else t.T.contiguous()


def rows_op(f: Operator, one_d: bool):
    """``f`` (written for (n,) or (n, k)) applied to (k, n) rows."""
    if one_d:
        return lambda t: f(t[0])[None]
    return lambda t: f(t.T.contiguous()).T.contiguous()


def local_row_dots(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Local dot of each row pair: (k,)."""
    if u.shape[0] == 1:
        return torch.dot(u[0], v[0]).reshape(1)
    return (u * v).sum(dim=1)


def row_dots(comm: Comm, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Global dot of each row pair: (k,)."""
    return comm.psum(local_row_dots(u, v))


def row_norms(comm: Comm, t: torch.Tensor, compensated: bool = False):
    """Global 2-norm of each row, plain or double-single (Dot2)."""
    if compensated:
        return torch.sqrt(psum_ff(comm, torch.stack(comp_dot(t, t, dim=1))))
    return torch.sqrt(row_dots(comm, t, t))


def inv_or_inf(scale: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Per-row divisor: ``scale`` where ``keep`` and scale ≠ 0, else +inf, so
    that t / divisor is t / scale, or 0 (the reference's safe_divide, and a
    frozen row's zero)."""
    ok = keep & (scale != 0)
    return torch.where(ok, scale, torch.full_like(scale, math.inf))


def host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def tolerance(bnorm: np.ndarray, rtol, atol) -> np.ndarray:
    """||r|| <= rtol·||b|| + atol in b's dtype; a zero RHS scales by 1."""
    dt = bnorm.dtype.type
    scale = np.where(bnorm > 0, bnorm, dt(1))
    return dt(rtol) * scale + dt(atol)


class Lsq:
    """The per-column Givens least-squares state of one restart cycle, on
    the host in b's dtype: rotations cs, sn (k, m), rhs g (k, m+1), the
    rotated Hessenberg (R factor) h_rot (k, m+1, m)."""

    def __init__(self, beta: np.ndarray, m: int):
        k, dt = beta.shape[0], beta.dtype
        self.cs = np.zeros((k, m), dt)
        self.sn = np.zeros((k, m), dt)
        self.g = np.zeros((k, m + 1), dt)
        self.g[:, 0] = beta
        self.h_rot = np.zeros((k, m + 1, m), dt)

    def step(self, h: np.ndarray, j: int, a: np.ndarray) -> None:
        """Rotate the new Hessenberg column h (k, m+1) by rotations
        0..j−1, make rotation j and update g and R, for the rows ``a``."""
        hs = h[a].copy()
        cs, sn = self.cs[a], self.sn[a]
        for i in range(j):
            hi, hi1 = hs[:, i].copy(), hs[:, i + 1].copy()
            hs[:, i] = cs[:, i] * hi + sn[:, i] * hi1
            hs[:, i + 1] = -sn[:, i] * hi + cs[:, i] * hi1
        hj, hj1 = hs[:, j], hs[:, j + 1]
        denom = np.sqrt(hj * hj + hj1 * hj1)
        pos = denom > 0
        safe = np.where(pos, denom, 1).astype(denom.dtype)
        c_new = np.where(pos, hj / safe, 1).astype(denom.dtype)
        s_new = np.where(pos, hj1 / safe, 0).astype(denom.dtype)
        self.cs[a, j] = c_new
        self.sn[a, j] = s_new
        hs[:, j] = denom
        hs[:, j + 1] = 0
        gj = self.g[a, j]
        self.g[a, j + 1] = -s_new * gj
        self.g[a, j] = c_new * gj
        self.h_rot[a, :, j] = hs

    def solve(self, jc: np.ndarray) -> np.ndarray:
        """y = R⁻¹ g on each row's leading jc×jc block, zero past it:
        (k, max jc)."""
        y = np.zeros((len(jc), int(jc.max(initial=0))), self.g.dtype)
        for c in np.flatnonzero(jc):
            j = jc[c]
            r = torch.from_numpy(self.h_rot[c, :j, :j].copy())
            g = torch.from_numpy(self.g[c, :j, None].copy())
            y[c, :j] = torch.linalg.solve_triangular(
                r, g, upper=True)[:, 0].numpy()
        return y


def hbar_sv_range(h_raw: np.ndarray, j: int):
    """Extreme squared singular values of the Arnoldi Hessenberg H̄_j
    ((j+1)×j, zero-padded to (m+1, m)): the extreme eigenvalues of the
    masked Gram matrix H̄ᵀH̄ whose unused diagonal slots hold the first
    column's squared norm (inside the range, so it never moves it); j = 0
    gives (1, 1)."""
    m = h_raw.shape[1]
    dt = h_raw.dtype.type
    colv = np.arange(m) < j
    rowv = np.arange(m + 1) <= j
    hm = np.where(colv[None, :] & rowv[:, None], h_raw, dt(0))
    gram = hm.T @ hm
    fill = gram[0, 0] if j > 0 else dt(1)
    gm = np.where(colv[None, :] & colv[:, None], gram,
                  fill * np.eye(m, dtype=h_raw.dtype))
    w = np.linalg.eigvalsh(gm)
    return w[-1], max(w[0], np.finfo(h_raw.dtype).tiny)


def stop_mask(stop, iters: np.ndarray, res: np.ndarray, bnorm: np.ndarray,
              rows: np.ndarray) -> np.ndarray:
    """``stop`` evaluated one column at a time (as under the reference's
    vmap) for the columns in ``rows``; False elsewhere."""
    out = np.zeros(len(res), bool)
    for c in np.flatnonzero(rows):
        out[c] = bool(stop(SolverState(
            iters=torch.tensor(int(iters[c])),
            resnorm=torch.from_numpy(res[c:c + 1].copy())[0],
            rhs_norm=torch.from_numpy(bnorm[c:c + 1].copy())[0])))
    return out


def _projector(comm, ortho, m, window_chunk):
    """(basis columns, project(v_prefix_source, w, j) -> (w2, c)) for one
    Arnoldi step j; v is the whole (k, mcols, n) basis in w's dtype or
    narrower."""
    if ortho in ("MGS1", "IMGS"):
        passes = 2 if ortho == "IMGS" else 1
        return m + 1, lambda v, w, j: mgs_project_rows(
            comm, v[:, :j + 1], w, passes)
    proj = cgs2_project_rows if ortho == "CGS2" else dgks_project_rows
    if window_chunk:
        chunk = int(window_chunk)
        mcols = -(-(m + 1) // chunk) * chunk

        def ncols(j):
            return min(-(-(j + 1) // chunk) * chunk, mcols)
    else:
        mcols = m + 1

        def ncols(j):
            return j + 1

    def project(v, w, j):
        vp = v[:, :ncols(j)]
        return proj(comm, vp if vp.dtype == w.dtype else vp.to(w.dtype), w)

    return mcols, project


def _gmres_rows(op, b, x0, *, prec, flexible, restart, maxiter, rtol, atol,
                comm, ortho, condest, window_chunk, stop, history,
                compensated, basis_dtype, one_d):
    """Restarted right-preconditioned GMRES on k columns at once, b and x0
    as (k, n) rows. Returns (x rows, iters (k,), res (k,), tol (k,),
    condest (k,) or None, history (L, k) or None), the small ones numpy."""
    k, n = b.shape
    m = restart
    dt, dev = b.dtype, b.device
    bdt = basis_dtype or dt
    A, M = rows_op(op, one_d), rows_op(prec, one_d)
    mcols, project = _projector(comm, ortho, m, window_chunk)

    def norms(t):
        return row_norms(comm, t, compensated)

    bnorm = host(norms(b))
    tol = tolerance(bnorm, rtol, atol)
    npdt = bnorm.dtype
    v = torch.zeros((k, mcols, n), dtype=bdt, device=dev)
    z = torch.zeros((k, m, n), dtype=dt, device=dev) if flexible else None
    hist = np.full((maxiter + m + 1, k), np.nan, npdt) if history else None

    def device_mask(rows):
        return torch.from_numpy(rows).to(dev)

    def cycle(x, r, beta, total, run):
        """One restart cycle of the columns ``run`` from their true residual
        r (norms beta); the others keep their state. Returns (x, r, beta,
        total, (σmax², σmin²) or None)."""
        if window_chunk:
            v.zero_()  # the windowed pass reads unfilled columns
        run_t = device_mask(run)
        v[:, 0] = r / inv_or_inf(torch.from_numpy(beta).to(dev),
                                 run_t)[:, None]
        lsq = Lsq(beta, m)
        h_raw = np.zeros((k, m + 1, m), npdt) if condest else None
        if history:
            first = run & (total == 0)
            hist[0, first] = beta[first]
        jc = np.zeros(k, np.int64)

        def going(j):
            gj = np.abs(lsq.g[:, j])
            ok = run & (j < m) & (gj > tol)
            if stop is not None:
                ok &= ~stop_mask(stop, total + j, gj, bnorm, ok)
            return ok

        act, j = going(0), 0
        act_seen = act_t = None
        while act.any():
            if not np.array_equal(act, act_seen):  # one upload a change
                act_seen, act_t = act, device_mask(act)
            vj = v[:, j] if bdt == dt else v[:, j].to(dt)
            zj = M(vj)
            if flexible:
                z[:, j] = zj
            w2, hcol = project(v, A(zj), j)
            hnorm = norms(w2)
            den = inv_or_inf(hnorm, act_t)[:, None]
            if bdt == dt:
                torch.div(w2, den, out=v[:, j + 1])  # no temporary
            else:
                v[:, j + 1] = w2 / den
            got = host(torch.cat([hcol[:, :j + 1], hnorm[:, None]], dim=1))
            h = np.zeros((k, m + 1), npdt)
            h[:, :j + 2] = got
            a = np.flatnonzero(act)
            if condest:
                h_raw[a, :, j] = h[a]
            lsq.step(h, j, a)
            jc[a] = j + 1
            if history:
                hist[total[a] + j + 1, a] = np.abs(lsq.g[a, j + 1])
            j += 1
            act = act & going(j)
        jmax = int(jc.max(initial=0))
        x_new = x
        if jmax:
            y = torch.from_numpy(lsq.solve(jc)).to(dev)[:, :, None]
            if flexible:
                corr = torch.bmm(z[:, :jmax].transpose(1, 2), y)[:, :, 0]
            else:
                vp = v[:, :jmax] if bdt == dt else v[:, :jmax].to(dt)
                corr = M(torch.bmm(vp.transpose(1, 2), y)[:, :, 0])
            x_new = x + corr
            if not run.all():
                x_new = torch.where(run_t[:, None], x_new, x)
        # the end-of-cycle TRUE residual gates the next restart
        r_new = b - A(x_new)
        if not run.all():
            r_new = torch.where(run_t[:, None], r_new, r)
        beta_new = np.where(run, host(norms(r_new)), beta)
        sv = None
        if condest:
            sv = np.ones((2, k), npdt)
            for c in np.flatnonzero(run):
                sv[:, c] = hbar_sv_range(h_raw[c], jc[c])
        return x_new, r_new, beta_new, total + jc, sv

    r0 = b - A(x0)
    beta0 = host(norms(r0))
    total = np.zeros(k, np.int64)
    # one cycle always runs; then restart while the true residual needs it
    x, r, res, total, sv = cycle(x0, r0, beta0, total, np.ones(k, bool))
    prev = beta0
    while True:
        run = (total < maxiter) & (res > tol) & (res < prev * npdt.type(
            STALL_RATIO))
        if stop is not None:
            run &= ~stop_mask(stop, total, res, bnorm, run)
        if not run.any():
            break
        x, r, res_new, total, sv_new = cycle(x, r, res, total, run)
        if condest:
            # keep the widest certified bracket over the cycles
            sv = np.where(run, np.stack([np.maximum(sv_new[0], sv[0]),
                                         np.minimum(sv_new[1], sv[1])]), sv)
        prev = np.where(run, res, prev)
        res = res_new
    ce = np.sqrt(sv[0] / sv[1]) if condest else None
    return x, total, res, tol, ce, hist


def finish(x_rows, total, res, tol, one_d, dev, condest=None, history=None):
    """The SolveResult of a rows solve, shaped like b."""
    def out(a):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return t[..., 0] if one_d else t

    resnorm = out(res)
    return SolveResult(
        x=from_rows(x_rows, one_d), iters=int(total.max()),
        resnorm=resnorm, converged=out(res <= tol),
        condest=None if condest is None else out(condest),
        history=None if history is None else out(history))


def gmres(op: Operator, b: torch.Tensor, x0: torch.Tensor | None = None, *,
          prec: Operator | None = None, flexible: bool = False,
          restart: int = 30, maxiter: int = 1000, rtol: float = 1e-8,
          atol: float = 0.0, comm: Comm | None = None, ortho: str = "CGS2",
          condest: bool = False, window_chunk: int | None = None,
          stop=None, history: bool = False, compensated: bool = False,
          basis_dtype=None) -> SolveResult:
    """Restarted GMRES(m) with right preconditioning.

    A multivector b (n, k) runs as pseudo-block GMRES (module docstring).
    ``condest=True`` reports a lower bound on κ₂ of the preconditioned
    operator from the singular range of the Arnoldi Hessenberg (the widest
    bracket over the cycles). ``stop``: a status test (``solvers.status``),
    evaluated every iteration and at every restart; passing means stop.
    ``history=True`` records the implicit residual |g_{j+1}| of every
    iteration in a (maxiter+restart+1,) or (maxiter+restart+1, k) tensor,
    NaN past the last (the final cycle may run past maxiter).
    ``compensated=True`` takes the norms with double-single (Dot2) sums.
    ``basis_dtype`` (e.g. ``torch.bfloat16``) stores the Krylov basis
    narrower while working vectors, reductions and the Givens recurrence
    stay in b's dtype; the basis prefix is widened to b's dtype once an
    Arnoldi step for its products (PyTorch has no mixed-dtype GEMM).
    ``window_chunk`` (single RHS only, as in the reference) rounds the
    projected prefix up to a multiple of the chunk. ``iters`` is the
    largest iteration count over the columns."""
    comm = comm or SerialComm()
    if b.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"gmres: b must be float32 or float64, got {b.dtype}")
    one_d = b.ndim == 1
    x0 = torch.zeros_like(b) if x0 is None else x0
    x, total, res, tol, ce, hist = _gmres_rows(
        op, to_rows(b), to_rows(x0), prec=prec or identity_prec,
        flexible=flexible, restart=restart, maxiter=maxiter, rtol=rtol,
        atol=atol, comm=comm, ortho=resolve_method(ortho), condest=condest,
        window_chunk=window_chunk if one_d else None, stop=stop,
        history=history, compensated=compensated, basis_dtype=basis_dtype,
        one_d=one_d)
    return finish(x, total, res, tol, one_d, b.device, ce, hist)


def fgmres(op: Operator, b: torch.Tensor, x0: torch.Tensor | None = None,
           **kw) -> SolveResult:
    """Flexible GMRES (the right preconditioner may change every
    iteration)."""
    return gmres(op, b, x0, flexible=True, **kw)
