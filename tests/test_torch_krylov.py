"""The port's BiCGStab, TFQMR, MINRES, LSQR, fixed-point and block CG
against the JAX package's.

On ``laplace2d`` (SPD), its shift by −2 (indefinite, for MINRES) and
``recirc2d`` (nonsymmetric, diffusion 0.1), each stored as DIA by both
packages from one host matrix, the same seeded right-hand sides go
through both packages' solvers in f64: equal iteration counts and x to
1e-10 (max|Δ| / max|x|), with and without a preconditioner, one column
and several. LSQR also with Tikhonov damping. BiCGStab on laplace2d and
LSQR past ≈ 30 fixed steps amplify rounding far above 1e-10 in both
packages; those cases are held as their docstrings say. Block CG on a block with a
dependent column: both converge with true residuals below the tolerance,
and their counts are not compared (the block coefficients of a dependent
block follow rounding). The block coefficients' rank-robust solve
(``_ls_solve``: an SVD with ``jnp.linalg.lstsq``'s cut-off) is held to
``jnp.linalg.lstsq`` to 1e-12 on full-rank and rank-deficient systems.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trilinos_tpu.galeri import laplace2d as j_laplace2d
from trilinos_tpu.galeri import recirc2d as j_recirc2d
from trilinos_tpu.ops import formats as JF
from trilinos_tpu.ops import matvec as JS
from trilinos_tpu.solvers import bicgstab as j_bicgstab
from trilinos_tpu.solvers import block_cg as j_block_cg
from trilinos_tpu.solvers import fixed_point as j_fixed_point
from trilinos_tpu.solvers import lsqr as j_lsqr
from trilinos_tpu.solvers import minres as j_minres
from trilinos_tpu.solvers import tfqmr as j_tfqmr

from trilinos_tpu_torch.ops import formats as TF
from trilinos_tpu_torch.ops import matvec as TS
from trilinos_tpu_torch.solvers import (bicgstab, block_cg, fixed_point,
                                        lsqr, minres, tfqmr)
from trilinos_tpu_torch.solvers.block_cg import _ls_solve
from torch_threads import one_thread  # noqa: F401  (autouse)

X_TOL = 1e-10


def _problem(a):
    ja = JF.csr_to_dia(a, dtype=np.float64)
    ta = TF.csr_to_dia(TF.CsrHost(a.row_ptr, a.cols, a.vals, a.shape),
                       device="cpu")
    return dict(
        a=a, npad=ja.n_rows_pad,
        jop=lambda x: JS.spmv(ja, x, impl="xla"),
        top=lambda x: TS.spmv(ta, x),
        jop_t=lambda x: JS.spmv(ja, x, transpose=True, impl="xla"),
        top_t=lambda x: TS.spmv(ta, x, transpose=True))


PROBLEMS = {"laplace2d": _problem(j_laplace2d(14, 14)),
            "recirc2d": _problem(j_recirc2d(12, 12, diff=0.1)),
            "small": _problem(j_laplace2d(8, 8))}
SHIFT = 1.3  # laplace2d(14, 14) − 1.3 I: 19 eigenvalues below 0, min |λ| 0.023


def rhs(name, k=None, seed=5):
    p = PROBLEMS[name]
    n = p["a"].shape[0]
    b = np.zeros((p["npad"],) if k is None else (p["npad"], k))
    b[:n] = np.random.default_rng(seed).standard_normal(b[:n].shape)
    return b


def jacobi(name):
    """(JAX, port) inverse-diagonal preconditioners, 1 on the pad rows."""
    p = PROBLEMS[name]
    d = np.ones(p["npad"])
    d[:p["a"].shape[0]] = 1.0 / p["a"].diagonal()
    jd, td = jnp.asarray(d), torch.from_numpy(d)
    return ((lambda v: (jd if v.ndim == 1 else jd[:, None]) * v),
            (lambda v: (td if v.ndim == 1 else td[:, None]) * v))


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def true_rel(name, b, x, shift=0.0):
    a = PROBLEMS[name]["a"]
    n = a.shape[0]
    dense = a.to_dense() - shift * np.eye(n)
    r = b[:n] - dense @ np.asarray(x)[:n]
    return np.linalg.norm(r, axis=0) / np.linalg.norm(b[:n], axis=0)


def run_both(tsolve, jsolve, name, b, prec=False, shift=0.0, **kw):
    p = PROBLEMS[name]
    jop, top = p["jop"], p["top"]
    if shift:
        jop = (lambda f: lambda x: f(x) - shift * x)(jop)
        top = (lambda f: lambda x: f(x) - shift * x)(top)
    jkw, tkw = dict(kw), dict(kw)
    if prec:
        jkw["prec"], tkw["prec"] = jacobi(name)
    jr = jsolve(jop, jnp.asarray(b), **jkw)
    tr = tsolve(top, torch.from_numpy(b), **tkw)
    assert tr.iters == int(jr.iters)
    assert rel(tr.x.numpy(), jr.x) <= X_TOL
    np.testing.assert_array_equal(np.asarray(tr.converged),
                                  np.asarray(jr.converged))
    return tr


@pytest.mark.parametrize("tsolve,jsolve", [(bicgstab, j_bicgstab),
                                           (tfqmr, j_tfqmr)])
@pytest.mark.parametrize("name,k,prec", [
    ("recirc2d", None, False), ("recirc2d", None, True),
    ("recirc2d", 3, False), ("recirc2d", 2, True)])
def test_bicgstab_tfqmr_match_jax(tsolve, jsolve, name, k, prec):
    b = rhs(name, k)
    res = run_both(tsolve, jsolve, name, b, prec=prec, rtol=1e-10,
                   maxiter=2000)
    assert bool(res.converged.all())
    assert (true_rel(name, b, res.x) <= 1e-9).all()


@pytest.mark.parametrize("prec", [False, True])
def test_tfqmr_symmetric_matches_jax(prec):
    b = rhs("laplace2d")
    res = run_both(tfqmr, j_tfqmr, "laplace2d", b, prec=prec, rtol=1e-10,
                   maxiter=2000)
    assert (true_rel("laplace2d", b, res.x) <= 1e-9).all()


def test_bicgstab_symmetric_follows_rounding():
    """BiCGStab on the symmetric laplace2d: its ω steps
    amplify the two packages' rounding differences about 1e6-fold within
    30 iterations (x 6e-10 apart at iteration 30, 39 against 40
    iterations to rtol 1e-10), so here the iterations are held to ±1 and
    each x to the true-residual gate, as for a dependent block."""
    p = PROBLEMS["laplace2d"]
    b = rhs("laplace2d")
    jr = j_bicgstab(p["jop"], jnp.asarray(b), rtol=1e-10, maxiter=2000)
    tr = bicgstab(p["top"], torch.from_numpy(b), rtol=1e-10, maxiter=2000)
    assert bool(tr.converged) and bool(jr.converged)
    assert abs(tr.iters - int(jr.iters)) <= 1
    for x in (tr.x.numpy(), np.asarray(jr.x)):
        assert true_rel("laplace2d", b, x) <= 1e-10


@pytest.mark.parametrize("shift,k,prec", [(0.0, None, False),
                                          (SHIFT, None, False),
                                          (0.0, None, True), (SHIFT, 2, False)])
def test_minres_matches_jax(shift, k, prec):
    b = rhs("laplace2d", k)
    res = run_both(minres, j_minres, "laplace2d", b, prec=prec, shift=shift,
                   rtol=1e-10, maxiter=2000)
    assert bool(res.converged.all())
    assert (true_rel("laplace2d", b, res.x, shift) <= 1e-9).all()


@pytest.mark.parametrize("damp", [0.0, 0.5])
def test_lsqr_matches_jax(damp):
    p = PROBLEMS["recirc2d"]
    b = rhs("recirc2d")
    jr = j_lsqr(p["jop"], p["jop_t"], jnp.asarray(b), rtol=1e-10,
                maxiter=5000, damp=damp)
    tr = lsqr(p["top"], p["top_t"], torch.from_numpy(b), rtol=1e-10,
              maxiter=5000, damp=damp)
    assert tr.iters == int(jr.iters)
    assert rel(tr.x.numpy(), jr.x) <= X_TOL
    # |φ̄| at the tolerance is rounding-sized: held to 1e-10 of ‖b‖
    assert abs(float(tr.resnorm) - float(jr.resnorm)) <= 1e-10 * float(
        np.linalg.norm(b))
    if damp == 0.0:
        assert bool(tr.converged)
        assert true_rel("recirc2d", b, tr.x) <= 1e-8


def test_lsqr_fixed_iterations_match_jax():
    """rtol 0 at a fixed count, as the card's LSQR phase runs it. Without
    reorthogonalization the Golub–Kahan vectors lose orthogonality after
    ≈ 30 steps here, and the two packages' rounding (their transposes sum
    in another order) then grows apart (2e-8 by step 40; converged solves
    agree again), so the fixed count is 20."""
    p = PROBLEMS["laplace2d"]
    b = rhs("laplace2d")
    jr = j_lsqr(p["jop"], p["jop_t"], jnp.asarray(b), rtol=0.0, maxiter=20)
    tr = lsqr(p["top"], p["top_t"], torch.from_numpy(b), rtol=0.0,
              maxiter=20)
    assert tr.iters == int(jr.iters) == 20
    assert rel(tr.x.numpy(), jr.x) <= X_TOL


@pytest.mark.parametrize("omega,k", [(1.0, None), (0.8, 2)])
def test_fixed_point_matches_jax(omega, k):
    b = rhs("small", k)
    res = run_both(fixed_point, j_fixed_point, "small", b, prec=True,
                   omega=omega, rtol=1e-8, maxiter=5000)
    assert bool(res.converged.all())
    assert (true_rel("small", b, res.x) <= 1e-7).all()


@pytest.mark.parametrize("k,prec", [(4, False), (4, True), (None, False)])
def test_block_cg_matches_jax(k, prec):
    b = rhs("laplace2d", k)
    res = run_both(block_cg, j_block_cg, "laplace2d", b, prec=prec,
                   rtol=1e-10, maxiter=500)
    assert res.x.shape == b.shape
    assert bool(res.converged.all())
    assert (true_rel("laplace2d", b, res.x) <= 1e-9).all()


def test_block_cg_dependent_column():
    """Column 3 = column 0: the block coefficients are rank-deficient; both
    packages still converge every column."""
    b = rhs("laplace2d", 4)
    b[:, 3] = b[:, 0]
    p = PROBLEMS["laplace2d"]
    jr = j_block_cg(p["jop"], jnp.asarray(b), rtol=1e-8, maxiter=500)
    tr = block_cg(p["top"], torch.from_numpy(b), rtol=1e-8, maxiter=500)
    assert bool(tr.converged.all()) and bool(np.asarray(jr.converged).all())
    for x in (tr.x.numpy(), np.asarray(jr.x)):
        assert (true_rel("laplace2d", b, x) <= 1e-8).all()
    assert rel(tr.x.numpy(), jr.x) <= 1e-7


@pytest.mark.parametrize("case", ["full", "dependent", "zero_row",
                                  "wide_rhs"])
def test_ls_solve_matches_jnp_lstsq(case):
    rng = np.random.default_rng(9)
    a = rng.standard_normal((5, 5))
    rhs_ = rng.standard_normal((5, 3))
    if case == "dependent":
        a[:, 4] = a[:, 1] + 2.0 * a[:, 2]
        a[3] = a[0]
    elif case == "zero_row":
        a[2] = 0.0
        a[:, 2] = 0.0
    elif case == "wide_rhs":
        rhs_ = rng.standard_normal((5, 8))
    want = np.asarray(jnp.linalg.lstsq(jnp.asarray(a), jnp.asarray(rhs_))[0])
    got = _ls_solve(torch.from_numpy(a), torch.from_numpy(rhs_)).numpy()
    assert np.abs(got - want).max() <= 1e-12 * max(np.abs(want).max(), 1.0)
