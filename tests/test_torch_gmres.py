"""The port's GMRES family against the JAX package's.

On ``laplace3d(8, 8, 8)`` and the nonsymmetric ``recirc2d(12, 12)``
(diffusion 0.1), stored as ELL by both packages from one host matrix, the
same right-hand sides (numpy seeds) go through ``gmres``/``fgmres``/
``gmres_single_reduce``/``gmres_pipeline`` of both: equal iteration counts
and x to 1e-9 (max|Δ| / max|x|), f64, for every ortho method, the windowed
projection, a preconditioner that changes every call (fgmres), condest
(1e-9) and history (the same NaN pattern, values to 1e-9 of the largest),
a stop test, compensated norms, the stall guard on an unattainable rtol,
and pseudo-block solves whose columns converge at different iterations
(each column equals its own one-column solve in both packages; ``iters``
is the largest). A bf16 basis (f32 b) must converge and meet the true
residual gate; its iterations are not compared, since bf16 rounding
follows the summation order. Last, the BASELINE config 2 twin at 8³: the
port's ``bsr_gmres_entry`` (BSR b = 4, Relaxation, GMRES(30), nrhs 4)
against the JAX test's pipeline (``tests/test_baseline_configs.py``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trilinos_tpu import precond as jprec
from trilinos_tpu.galeri import laplace2d as j_laplace2d
from trilinos_tpu.galeri import laplace3d as j_laplace3d
from trilinos_tpu.galeri import recirc2d as j_recirc2d
from trilinos_tpu.ops import formats as JF
from trilinos_tpu.ops import matvec as JS
from trilinos_tpu.solvers import fgmres as j_fgmres
from trilinos_tpu.solvers import gmres as j_gmres
from trilinos_tpu.solvers import status as jstatus
from trilinos_tpu.solvers.gmres_ca import gmres_pipeline as j_pipe
from trilinos_tpu.solvers.gmres_ca import gmres_single_reduce as j_sr

from trilinos_tpu_torch.entry import bsr_gmres_entry
from trilinos_tpu_torch.ops import formats as TF
from trilinos_tpu_torch.ops import matvec as TS
from trilinos_tpu_torch.solvers import (fgmres, gmres, gmres_pipeline,
                                        gmres_single_reduce)
from trilinos_tpu_torch.solvers import status as tstatus

X_TOL = 1e-9


def _problem(name):
    a = (j_laplace3d(8, 8, 8) if name == "laplace3d"
         else j_recirc2d(12, 12, diff=0.1))
    ja = JF.csr_to_ell(a)
    ta = TF.csr_to_ell(TF.CsrHost(a.row_ptr, a.cols, a.vals, a.shape),
                       device="cpu")
    return a, (lambda x: JS.spmv(ja, x, impl="xla")), (
        lambda x: TS.spmv(ta, x)), ja.n_rows_pad


PROBLEMS = {name: _problem(name) for name in ("laplace3d", "recirc2d")}
KW = {"laplace3d": dict(rtol=1e-10, restart=10, maxiter=300),
      "recirc2d": dict(rtol=1e-10, restart=20, maxiter=400)}


def rhs(name, k=None, seed=0):
    a, _, _, npad = PROBLEMS[name]
    n = a.shape[0]
    b = np.zeros((npad,) if k is None else (npad, k))
    b[:n] = np.random.default_rng(seed).standard_normal(b[:n].shape)
    return b


def x_err(tx, jx):
    jx = np.asarray(jx)
    return np.abs(tx.numpy() - jx).max() / np.abs(jx).max()


def run_both(name, b, jsolve=j_gmres, tsolve=gmres, jkw=None, tkw=None,
             **kw):
    _, jop, top, _ = PROBLEMS[name]
    kw = {**KW[name], **kw}
    jr = jsolve(jop, jnp.asarray(b), **kw, **(jkw or {}))
    tr = tsolve(top, torch.from_numpy(b), **kw, **(tkw or {}))
    assert tr.iters == int(jr.iters), (tr.iters, int(jr.iters))
    assert x_err(tr.x, jr.x) <= X_TOL, x_err(tr.x, jr.x)
    np.testing.assert_array_equal(tr.converged.numpy(),
                                  np.asarray(jr.converged))
    np.testing.assert_allclose(tr.resnorm.numpy(), np.asarray(jr.resnorm),
                               rtol=1e-5)
    return jr, tr


@pytest.mark.parametrize("name", ["laplace3d", "recirc2d"])
@pytest.mark.parametrize("ortho", ["CGS2", "DGKS", "MGS1", "IMGS"])
def test_ortho_methods_match(name, ortho):
    jr, tr = run_both(name, rhs(name), ortho=ortho)
    assert bool(tr.converged)


@pytest.mark.parametrize("name", ["laplace3d", "recirc2d"])
@pytest.mark.parametrize("ortho", ["CGS2", "DGKS"])
def test_window_chunk_matches(name, ortho):
    run_both(name, rhs(name), ortho=ortho, window_chunk=4)


def test_fgmres_changing_preconditioner():
    """A preconditioner that changes with its input (so with every call):
    flexible GMRES keeps the preconditioned vectors."""
    a, _, _, npad = PROBLEMS["recirc2d"]
    d = np.zeros(npad)
    d[:a.shape[0]] = 1.0 / a.diagonal()
    jd, td = jnp.asarray(d), torch.from_numpy(d)

    def jprec_(v):
        return jd * v * (1.5 + jnp.sin(jnp.sum(v)))

    def tprec_(v):
        return td * v * (1.5 + torch.sin(torch.sum(v)))

    jr, tr = run_both("recirc2d", rhs("recirc2d"), jsolve=j_fgmres,
                      tsolve=fgmres, jkw=dict(prec=jprec_),
                      tkw=dict(prec=tprec_))
    assert bool(tr.converged)


@pytest.mark.parametrize("k", [None, 3])
def test_condest_and_history_match(k):
    # rtol 1e-9: at 1e-10 the last cycles' Hessenbergs are rounding noise,
    # and the running σmin bracket follows it (3.8e-9 apart in one column)
    jr, tr = run_both("recirc2d", rhs("recirc2d", k), rtol=1e-9,
                      condest=True, history=True)
    np.testing.assert_allclose(tr.condest.numpy(), np.asarray(jr.condest),
                               rtol=1e-9)
    h, jh = tr.history.numpy(), np.asarray(jr.history)
    assert h.shape == jh.shape
    np.testing.assert_array_equal(np.isnan(h), np.isnan(jh))
    fin = ~np.isnan(jh)
    assert np.abs(h[fin] - jh[fin]).max() <= X_TOL * np.abs(jh[fin]).max()


def test_stop_and_compensated_match():
    b = rhs("laplace3d", 2)
    jr, tr = run_both("laplace3d", b, rtol=1e-12,
                      jkw=dict(stop=jstatus.res_norm(1e-4)),
                      tkw=dict(stop=tstatus.res_norm(1e-4)))
    assert not bool(tr.converged.any())
    run_both("laplace3d", b, compensated=True)


@pytest.mark.parametrize("k", [None, 2])
def test_stall_guard_on_unattainable_rtol(k):
    """GMRES(10) cannot reduce the residual of a 40-cycle shift block
    (Krylov spaces of the cyclic shift on e_1 miss the solution), so the
    residual of [Laplace2D 6², shift] stagnates at that block's part while
    the Laplace part converges: the stall guard ends the solve at a cycle
    fixed by the mathematics, not by rounding."""
    lap = j_laplace2d(6, 6)
    rows = np.repeat(np.arange(36), lap.row_lengths())
    cols, vals = lap.cols, lap.vals
    shift = np.arange(40)
    a = JF.CsrHost.from_coo(np.r_[rows, 36 + shift],
                            np.r_[cols, 36 + (shift + 1) % 40],
                            np.r_[vals, np.ones(40)], (76, 76))
    ja = JF.csr_to_ell(a)
    ta = TF.csr_to_ell(TF.CsrHost(a.row_ptr, a.cols, a.vals, a.shape),
                       device="cpu")
    b = np.zeros((ja.n_rows_pad,) if k is None else (ja.n_rows_pad, k))
    b[:36] = np.random.default_rng(3).standard_normal(b[:36].shape)
    b[36] = 1.0
    kw = dict(rtol=1e-12, restart=10, maxiter=3000)
    jr = j_gmres(lambda x: JS.spmv(ja, x, impl="xla"), jnp.asarray(b), **kw)
    tr = gmres(lambda x: TS.spmv(ta, x), torch.from_numpy(b), **kw)
    assert tr.iters == int(jr.iters)
    assert 10 < tr.iters < 3000  # restarted, then the stall guard ended it
    assert not bool(tr.converged.any())
    assert x_err(tr.x, jr.x) <= X_TOL


def eigvec(i, j, k):
    """A Dirichlet eigenvector of Laplace3D 8³ (x fastest)."""
    t = np.arange(1, 9) * np.pi / 9
    return np.einsum("z,y,x->zyx", np.sin(k * t), np.sin(j * t),
                     np.sin(i * t)).ravel()


def test_pseudo_block_columns_freeze():
    """Columns that converge at different iterations: one eigenvector (one
    iteration), two eigenvectors (two) and a random vector. Each column of
    the batched solve equals its own one-column solve, in both packages;
    iters is the largest."""
    a, jop, top, npad = PROBLEMS["laplace3d"]
    n = a.shape[0]
    b = np.zeros((npad, 3))
    b[:n, 0] = eigvec(1, 1, 1)
    b[:n, 1] = eigvec(1, 1, 1) + eigvec(2, 1, 3)
    b[:n, 2] = np.random.default_rng(5).standard_normal(n)
    kw = dict(KW["laplace3d"], rtol=1e-9, history=True)
    tr = gmres(top, torch.from_numpy(b), **kw)
    jr = j_gmres(jop, jnp.asarray(b), **kw)
    singles = [gmres(top, torch.from_numpy(b[:, c].copy()), **kw)
               for c in range(3)]
    jsingles = [j_gmres(jop, jnp.asarray(b[:, c]), **kw) for c in range(3)]
    iters = [s.iters for s in singles]
    assert iters[:2] == [1, 2] and iters[2] > 2
    assert iters == [int(s.iters) for s in jsingles]
    assert tr.iters == int(jr.iters) == max(iters)
    for c in range(3):
        for s in (singles[c], jsingles[c]):
            sx = s.x.numpy() if isinstance(s.x, torch.Tensor) else np.asarray(
                s.x)
            assert np.abs(tr.x[:, c].numpy() - sx).max() <= X_TOL * np.abs(
                sx).max()
        # a frozen column's trace ends where its own solve's does
        h = tr.history[:, c].numpy()
        np.testing.assert_array_equal(np.isnan(h),
                                      np.isnan(singles[c].history.numpy()))
    assert x_err(tr.x, jr.x) <= X_TOL


def test_bf16_basis_converges():
    a, _, _, npad = PROBLEMS["laplace3d"]
    ta32 = TF.csr_to_ell(TF.CsrHost(a.row_ptr, a.cols, a.vals, a.shape),
                         dtype=np.float32, device="cpu")
    b = torch.from_numpy(rhs("laplace3d", 2)).float()
    rtol = 1e-4
    res = gmres(lambda x: TS.spmv(ta32, x), b, rtol=rtol, restart=10,
                maxiter=300, basis_dtype=torch.bfloat16)
    assert bool(res.converged.all())
    dense = a.to_dense()
    n = a.shape[0]
    b64, x64 = b.double().numpy()[:n], res.x.double().numpy()[:n]
    true = np.linalg.norm(b64 - dense @ x64, axis=0) / np.linalg.norm(
        b64, axis=0)
    assert (true <= rtol * 1.001).all(), true


@pytest.mark.parametrize("k", [None, 3])
@pytest.mark.parametrize("variant", ["single_reduce", "pipeline"])
def test_ca_variants_match(variant, k):
    jsolve, tsolve = {"single_reduce": (j_sr, gmres_single_reduce),
                      "pipeline": (j_pipe, gmres_pipeline)}[variant]
    jr, tr = run_both("recirc2d", rhs("recirc2d", k), jsolve=jsolve,
                      tsolve=tsolve, rtol=1e-9)
    assert bool(tr.converged.all())


def test_baseline_config2_twin():
    """BASELINE config 2 at 8³ through both packages' pipelines."""
    a = j_laplace3d(8, 8, 8)
    bsr = JF.csr_to_bsr(a, block_size=4)
    n = a.shape[0]
    npad = bsr.n_brows_pad * bsr.block_size
    m = jprec.Relaxation(a).compute()

    def prec(v):
        out = m(v[: m.dinv.shape[0]])
        pad = npad - out.shape[0]
        return jnp.pad(out, ((0, pad),) + ((0, 0),) * (out.ndim - 1))

    step, (b,) = bsr_gmres_entry(dims=(8, 8, 8), device="cpu")
    want = np.zeros((npad, 4))
    want[:n] = np.random.default_rng(1).standard_normal((n, 4))
    np.testing.assert_array_equal(b.numpy(), want)
    jr = j_gmres(lambda x: JS.spmv(bsr, x, impl="xla"), jnp.asarray(want),
                 prec=prec, restart=30, rtol=1e-8, maxiter=600)
    tr = step(b)
    assert tr.iters == int(jr.iters)
    assert x_err(tr.x, jr.x) <= X_TOL
    dense = a.to_dense()
    true = np.linalg.norm(want[:n] - dense @ tr.x.numpy()[:n], axis=0) / (
        np.linalg.norm(want[:n], axis=0))
    assert (true <= 1e-7).all()
