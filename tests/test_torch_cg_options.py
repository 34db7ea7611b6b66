"""The port's CG options, pipelined CG and stochastic CG against the JAX
package's.

On ``laplace2d`` stored as DIA by both packages from one host matrix, the
same seeded right-hand sides go through both packages' ``cg`` with the
Lanczos condition estimate (``condest_window``), the residual history,
a status test (``stop``) and double-single dots (``compensated``), and
through ``cg_pipeline`` and ``stochastic_cg``; f64 unless stated. Gates:
equal iteration counts, x to 1e-10 (max|Δ| / max|x|), condest to 1e-10
relative, the same history NaN pattern with values to 1e-10 of the
largest. The retry seam (a tighten-retry pass zeroes the β recorded at
its start): ``_tridiag_condest`` is twinned on recorded coefficients with
a zeroed β, and both packages run every pass at an unattainable rtol in
f64 and in f32 (as the JAX package's own test runs it), where the point
each pass stops follows rounding: there each estimate is held to the
dense κ as a lower bound, not to the other package. ``stochastic_cg`` draws its ξ
from a torch generator, so its sample y is held to its law instead: on a
6×6 SPD matrix with 20 000 right-hand-side columns and n = 6 steps, the
sample covariance of y must match A⁻¹ to 5% (Frobenius, relative; the
sampling error at this count is about 1%).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trilinos_tpu.galeri import laplace2d as j_laplace2d
from trilinos_tpu.ops import formats as JF
from trilinos_tpu.ops import matvec as JS
from trilinos_tpu.solvers import cg as j_cg
from trilinos_tpu.solvers import cg_pipeline as j_cg_pipeline
from trilinos_tpu.solvers import status as jstatus
from trilinos_tpu.solvers import stochastic_cg as j_stochastic_cg
from trilinos_tpu.solvers.factory import SolverManager as JManager
from trilinos_tpu.solvers.linear_problem import LinearProblem as JProblem

from trilinos_tpu_torch.ops import formats as TF
from trilinos_tpu_torch.ops import matvec as TS
from trilinos_tpu_torch.solvers import (LinearProblem, SolverManager, cg,
                                        cg_pipeline, stochastic_cg)
from trilinos_tpu_torch.solvers import status as tstatus
from torch_threads import one_thread  # noqa: F401  (autouse)

X_TOL = 1e-10
CONDEST_TOL = 1e-10
_PROBLEMS = {}


def problem(nx, dtype=np.float64):
    """(host matrix, JAX op, port op, padded rows) of laplace2d(nx, nx)."""
    key = (nx, np.dtype(dtype).name)
    if key not in _PROBLEMS:
        a = j_laplace2d(nx, nx)
        ja = JF.csr_to_dia(a, dtype=dtype)
        ta = TF.csr_to_dia(TF.CsrHost(a.row_ptr, a.cols, a.vals, a.shape),
                           dtype=dtype, device="cpu")
        _PROBLEMS[key] = (a, lambda x: JS.spmv(ja, x, impl="xla"),
                          lambda x: TS.spmv(ta, x), ja.n_rows_pad)
    return _PROBLEMS[key]


def rhs(nx, k=None, seed=3, dtype=np.float64):
    a, _, _, npad = problem(nx, dtype)
    n = a.shape[0]
    b = np.zeros((npad,) if k is None else (npad, k))
    b[:n] = np.random.default_rng(seed).standard_normal(b[:n].shape)
    return b.astype(dtype)


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def both(solver_t, solver_j, nx, b, **kw):
    _, jop, top, _ = problem(nx, b.dtype)
    jr = solver_j(jop, jnp.asarray(b), **kw)
    tr = solver_t(top, torch.from_numpy(b), **kw)
    return tr, jr


def dense_kappa(nx):
    w = np.linalg.eigvalsh(problem(nx)[0].to_dense())
    return w[-1] / w[0]


def assert_same(tr, jr, x_tol=X_TOL):
    assert tr.iters == int(jr.iters)
    assert rel(tr.x.numpy(), jr.x) <= x_tol
    np.testing.assert_array_equal(tr.converged.numpy(),
                                  np.asarray(jr.converged))


def assert_same_history(th, jh):
    th, jh = th.numpy(), np.asarray(jh)
    np.testing.assert_array_equal(np.isnan(th), np.isnan(jh))
    fin = ~np.isnan(jh)
    assert np.abs(th[fin] - jh[fin]).max() <= 1e-10 * np.abs(jh[fin]).max()


@pytest.mark.parametrize("nrhs", [None, 3])
def test_condest_matches_jax_and_dense_kappa(nrhs):
    b = rhs(16, nrhs)
    tr, jr = both(cg, j_cg, 16, b, rtol=1e-10, maxiter=500,
                  condest_window=200)
    assert_same(tr, jr)
    assert tr.condest.shape == (() if nrhs is None else (nrhs,))
    assert rel(tr.condest.numpy(), jr.condest) <= CONDEST_TOL
    np.testing.assert_allclose(tr.condest.numpy(), dense_kappa(16),
                               rtol=1e-6)


def test_condest_with_preconditioner():
    """Jacobi on the constant-diagonal Laplacian scales the operator
    uniformly: κ(M·A) = κ(A), in both packages."""
    b = rhs(16)
    _, jop, top, _ = problem(16)
    jr = j_cg(jop, jnp.asarray(b), prec=lambda v: 0.25 * v, rtol=1e-10,
              maxiter=500, condest_window=200)
    tr = cg(top, torch.from_numpy(b), prec=lambda v: 0.25 * v, rtol=1e-10,
            maxiter=500, condest_window=200)
    assert_same(tr, jr)
    assert rel(tr.condest.numpy(), jr.condest) <= CONDEST_TOL
    np.testing.assert_allclose(float(tr.condest), dense_kappa(16), rtol=1e-6)


def test_condest_window_smaller_than_iters():
    b = rhs(30)
    tr, jr = both(cg, j_cg, 30, b, rtol=1e-8, maxiter=500, condest_window=20)
    assert_same(tr, jr)
    assert tr.iters > 20
    assert rel(tr.condest.numpy(), jr.condest) <= CONDEST_TOL
    kappa = dense_kappa(30)
    assert 0.25 * kappa <= float(tr.condest) <= kappa * (1 + 1e-8)


def test_tridiag_condest_matches_jax():
    """The estimate from recorded coefficients, column by column: a full
    window, a partial one (unused slots), and a zeroed β at a retry seam
    (T the direct sum of two Lanczos blocks)."""
    from trilinos_tpu.solvers.cg import _tridiag_condest as j_condest
    from trilinos_tpu_torch.solvers.cg import _tridiag_condest

    rng = np.random.default_rng(4)
    alphas = rng.uniform(0.2, 1.0, (3, 12))
    betas = rng.uniform(0.05, 0.9, (3, 12))
    betas[1, 5] = 0.0  # the seam
    for m in (12, 7):
        got = _tridiag_condest(torch.from_numpy(alphas),
                               torch.from_numpy(betas), m).numpy()
        for c in range(3):
            want = float(j_condest(jnp.asarray(alphas[c]),
                                   jnp.asarray(betas[c]), m))
            assert abs(got[c] - want) <= CONDEST_TOL * want


def test_retry_seam_lower_bound_f64():
    """An unattainable rtol in f64: every certified pass runs (the point
    where each pass stops follows rounding, so the two packages' counts
    are not compared), each a fresh Lanczos process whose seam β is
    zeroed; the estimate stays a lower bound in both, and the history is
    finite exactly through the last iteration."""
    b = rhs(16)
    tr, jr = both(cg, j_cg, 16, b, rtol=1e-17, maxiter=2000,
                  condest_window=400, history=True)
    kappa = dense_kappa(16)
    for r in (tr, jr):
        assert not bool(r.converged)
        assert int(r.iters) > 100  # several passes of ≈ 40 iterations
        assert 0.99 * kappa <= float(r.condest) <= kappa * (1 + 1e-8)
        hist = np.asarray(r.history)
        assert np.isfinite(hist[:int(r.iters) + 1]).all()
        assert np.isnan(hist[int(r.iters) + 1:]).all()


def test_retry_seam_lower_bound_f32():
    """The JAX package's seam test in f32: rtol 3e-7 exhausts the retries,
    and the estimate stays a lower bound within f32 slack."""
    b = rhs(48, dtype=np.float32)
    tr, jr = both(cg, j_cg, 48, b, rtol=3e-7, maxiter=4000,
                  condest_window=400)
    kappa = dense_kappa(48)
    for r in (tr, jr):
        assert not bool(r.converged)
        assert 0.9 * kappa <= float(r.condest) <= kappa * (1 + 1e-3)


def test_condest_and_history_off_by_default():
    res = cg(problem(10)[2], torch.from_numpy(rhs(10)), rtol=1e-8)
    assert res.condest is None and res.history is None


@pytest.mark.parametrize("nrhs", [None, 4])
def test_history_matches_jax(nrhs):
    """Columns converge at different iterations: NaN past each column's
    last iteration in neither package (a frozen column keeps its last
    value), NaN past the solve's end in both."""
    b = rhs(14, nrhs)
    if nrhs:
        b[:, 1] *= 1e-3  # the same direction, converged much earlier
    tr, jr = both(cg, j_cg, 14, b, rtol=1e-9, maxiter=400, history=True)
    assert_same(tr, jr)
    assert tr.history.shape == (401,) + (() if nrhs is None else (nrhs,))
    assert_same_history(tr.history, jr.history)
    assert bool(torch.isnan(tr.history[tr.iters + 1:]).all())


def test_stop_test_matches_jax():
    """A status test that passes before the tolerance ends the solve; no
    retry pass follows."""
    b = rhs(16)
    _, jop, top, _ = problem(16)
    jr = j_cg(jop, jnp.asarray(b), rtol=1e-12, maxiter=500,
              stop=jstatus.res_norm(1e-4), history=True)
    tr = cg(top, torch.from_numpy(b), rtol=1e-12, maxiter=500,
            stop=tstatus.res_norm(1e-4), history=True)
    assert_same(tr, jr)
    assert not bool(tr.converged) and 0 < tr.iters < 60
    assert_same_history(tr.history, jr.history)
    tr = cg(top, torch.from_numpy(b), rtol=1e-12, maxiter=500,
            stop=tstatus.max_iters(7))
    jr = j_cg(jop, jnp.asarray(b), rtol=1e-12, maxiter=500,
              stop=jstatus.max_iters(7))
    assert tr.iters == int(jr.iters) == 7
    assert rel(tr.x.numpy(), jr.x) <= X_TOL


@pytest.mark.parametrize("nrhs", [None, 2])
def test_compensated_matches_jax(nrhs):
    tr, jr = both(cg, j_cg, 16, rhs(16, nrhs), rtol=1e-10, maxiter=500,
                  compensated=True)
    assert_same(tr, jr)
    assert bool(tr.converged.all())


def test_factory_condest_and_history():
    b = rhs(16)
    _, jop, top, _ = problem(16)
    params = {"Convergence Tolerance": 1e-10,
              "Estimate Condition Number": 200,
              "Record Residual History": True}
    jr = JManager("CG", dict(params)).solve(JProblem(jop, jnp.asarray(b)))
    tr = SolverManager("CG", dict(params)).solve(
        LinearProblem(top, torch.from_numpy(b)))
    assert_same(tr, jr)
    assert rel(tr.condest.numpy(), jr.condest) <= CONDEST_TOL
    assert_same_history(tr.history, jr.history)


@pytest.mark.parametrize("nx,nrhs,prec", [(100, None, False), (20, 3, False),
                                          (20, None, True)])
def test_cg_pipeline_matches_jax(nx, nrhs, prec):
    """BASELINE config 1's grid (100², ≈ 300 iterations: six residual
    replacements), a block of columns, and a Jacobi-like preconditioner."""
    b = rhs(nx, nrhs)
    kw = dict(rtol=1e-8, maxiter=2000)
    if prec:
        kw["prec"] = lambda v: 0.25 * v
    tr, jr = both(cg_pipeline, j_cg_pipeline, nx, b, **kw)
    assert_same(tr, jr)
    assert bool(tr.converged.all())
    a = problem(nx)[0]
    n = a.shape[0]
    x = tr.x.numpy()[:n]
    r = np.linalg.norm(b[:n] - a.to_dense() @ x, axis=0)
    assert (r <= 1.1e-8 * np.linalg.norm(b[:n], axis=0)).all()
    if nx == 100:
        assert tr.iters > 200  # several replacement segments


def test_cg_pipeline_replacement_schedule():
    """replace_every changes the iteration path; both packages follow the
    same one."""
    tr, jr = both(cg_pipeline, j_cg_pipeline, 30, rhs(30), rtol=1e-10,
                  maxiter=2000, replace_every=7)
    assert_same(tr, jr)


def test_stochastic_cg_x_and_iters_match_jax():
    b = rhs(16, 2)
    (tr, ty), (jr, jy) = both(stochastic_cg, j_stochastic_cg, 16, b,
                              rtol=1e-10, maxiter=500)
    assert_same(tr, jr)
    assert ty.shape == tuple(jy.shape)
    assert bool(torch.isfinite(ty).all())


def test_stochastic_cg_sample_covariance_is_inverse():
    rng = np.random.default_rng(11)
    q, _ = np.linalg.qr(rng.standard_normal((6, 6)))
    a = q @ np.diag([1.0, 1.5, 2.0, 3.0, 5.0, 8.0]) @ q.T
    b = rng.standard_normal((6, 20000))
    at = torch.from_numpy(a)
    gen = torch.Generator().manual_seed(5)
    res, y = stochastic_cg(lambda v: at @ v, torch.from_numpy(b), rtol=0.0,
                           maxiter=6, generator=gen)
    assert res.iters == 6
    np.testing.assert_allclose(res.x.numpy(), np.linalg.solve(a, b),
                               rtol=1e-8, atol=1e-8)
    ys = y.numpy()
    cov = ys @ ys.T / ys.shape[1]
    ainv = np.linalg.inv(a)
    assert np.linalg.norm(cov - ainv) / np.linalg.norm(ainv) <= 0.05
    # x and the iterations do not depend on the draws
    jr, _ = j_stochastic_cg(lambda v: jnp.asarray(a) @ v, jnp.asarray(b),
                            rtol=0.0, maxiter=6)
    assert int(jr.iters) == 6
    assert rel(res.x.numpy(), jr.x) <= X_TOL


def test_stochastic_cg_default_generator_is_seeded():
    b = torch.from_numpy(rhs(10))
    top = problem(10)[2]
    _, y1 = stochastic_cg(top, b, rtol=1e-8)
    _, y2 = stochastic_cg(top, b, rtol=1e-8)
    assert torch.equal(y1, y2)
