"""Port parity: the fused CG iteration and the single-reduce CG.

``cg_fused_iteration_plain`` is held against the JAX package's Pallas
kernel in interpret mode at 32×32×8 f32 over three chained iterations: the
vectors to 1e-5 and scal to 1e-5 (max|Δ| / max|y|; the TPU kernel sums its
dots chunk by chunk and the plain version with ``torch.sum``, and the
difference in α, β carries into the vectors). In f64 the port's
``cg_single_reduce`` takes the JAX package's iteration count exactly and
reaches its x to 1e-10; the port's ``cg_fused`` converges within one
iteration of its ``cg_single_reduce``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trilinos_tpu.galeri import laplace2d as j_laplace2d
from trilinos_tpu.galeri import laplace3d as j_laplace3d
from trilinos_tpu.ops import spmv as j_spmv
from trilinos_tpu.ops.pallas.cg_fused import (
    cg_fused_iteration as j_cg_fused_iteration)
from trilinos_tpu.solvers import cg_single_reduce as j_cg_single_reduce

from trilinos_tpu_torch.entry import fused_cg_entry
from trilinos_tpu_torch.galeri import laplace2d, laplace3d
from trilinos_tpu_torch.ops import (cg_fused_applicable, cg_fused_iteration,
                                    cg_fused_iteration_plain, spmv)
from trilinos_tpu_torch.solvers import cg_fused, cg_single_reduce
from torch_threads import one_thread  # noqa: F401  (autouse)


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def test_iteration_matches_pallas_interpret():
    jop = j_laplace3d(32, 32, 8, dtype=np.float32, fmt="stencil")
    top = laplace3d(32, 32, 8, dtype=np.float32, fmt="stencil")
    n = top.n_rows_pad
    b = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    w = np.asarray(j_spmv(jop, jnp.asarray(b)))
    scal = np.asarray([[b @ b, b @ w, 0.0, 1.0]], np.float32)
    zero = np.zeros(n, np.float32)
    j_state = [jnp.asarray(v) for v in (zero, b, w, zero, zero, scal)]
    t_state = [torch.from_numpy(np.array(v))
               for v in (zero, b, w, zero, zero, scal)]
    for it in range(3):
        j_state = j_cg_fused_iteration(jop, *j_state, interpret=True)
        t_state = cg_fused_iteration(top, *t_state)
        for name, got, want in zip("xrwpq", t_state, j_state):
            assert rel(got.numpy(), want) <= 1e-5, (it, name)
        assert t_state[5].shape == (1, 4)
        assert rel(t_state[5].numpy(), j_state[5]) <= 1e-5, it
    assert cg_fused_iteration.launches == 0


def test_plain_iteration_recurrence():
    """One plain iteration from a hand-made state: the closed forms."""
    op = laplace3d(8, 8, 16, dtype=np.float64, fmt="stencil")
    rng = np.random.default_rng(1)
    x, r, p, q = (torch.from_numpy(rng.standard_normal(op.n_rows))
                  for _ in range(4))
    w = spmv(op, r)
    scal = torch.tensor([[3.0, 5.0, 2.0, 0.5]], dtype=torch.float64)
    xo, ro, wo, po, qo, so = cg_fused_iteration_plain(op, x, r, w, p, q,
                                                      scal)
    beta = 3.0 / 2.0
    alpha = 3.0 / (5.0 - beta * 3.0 / 0.5)
    torch.testing.assert_close(po, r + beta * p)
    torch.testing.assert_close(qo, w + beta * q)
    torch.testing.assert_close(xo, x + alpha * po)
    torch.testing.assert_close(ro, r - alpha * qo)
    torch.testing.assert_close(wo, spmv(op, ro))
    torch.testing.assert_close(so, torch.stack(
        [ro @ ro, ro @ wo, torch.tensor(3.0, dtype=torch.float64),
         torch.tensor(alpha, dtype=torch.float64)]).reshape(1, 4))
    # the first pass: rz_prev = 0 gives β = 0, α = rz / δ
    first = cg_fused_iteration_plain(
        op, x, r, w, p, q, torch.tensor([[3.0, 5.0, 0.0, 1.0]],
                                        dtype=torch.float64))
    torch.testing.assert_close(first[3], r)
    torch.testing.assert_close(first[5][0, 3],
                               torch.tensor(0.6, dtype=torch.float64))


@pytest.mark.parametrize("prec", [False, True])
def test_single_reduce_matches_jax(prec):
    """BASELINE config 1's operator as a stencil, f64, rtol 1e-8; with and
    without a Jacobi preconditioner."""
    jop = j_laplace2d(100, 100, dtype=np.float64, fmt="stencil")
    top = laplace2d(100, 100, dtype=np.float64, fmt="stencil")
    b = np.zeros(top.n_rows_pad)
    b[:top.n_rows] = np.random.default_rng(2).standard_normal(top.n_rows)
    jm = (lambda v: 0.25 * v) if prec else None
    tm = (lambda v: 0.25 * v) if prec else None
    jres = j_cg_single_reduce(lambda v: j_spmv(jop, v), jnp.asarray(b),
                              prec=jm, rtol=1e-8, maxiter=2000)
    res = cg_single_reduce(lambda v: spmv(top, v), torch.from_numpy(b),
                           prec=tm, rtol=1e-8, maxiter=2000)
    assert bool(res.converged) and bool(jres.converged)
    assert res.iters == int(jres.iters)
    assert rel(res.x.numpy(), jres.x) <= 1e-10


def test_single_reduce_multivector_matches_jax():
    jop = j_laplace2d(24, 24, dtype=np.float64, fmt="stencil")
    top = laplace2d(24, 24, dtype=np.float64, fmt="stencil")
    b = np.zeros((top.n_rows_pad, 3))
    b[:top.n_rows] = np.random.default_rng(3).standard_normal(
        (top.n_rows, 3))
    b[:, 2] *= 1e-3  # columns converge at different iterations
    jres = j_cg_single_reduce(lambda v: j_spmv(jop, v), jnp.asarray(b),
                              rtol=1e-9, maxiter=500)
    res = cg_single_reduce(lambda v: spmv(top, v), torch.from_numpy(b),
                           rtol=1e-9, maxiter=500)
    assert res.iters == int(jres.iters)
    assert res.converged.tolist() == np.asarray(jres.converged).tolist()
    assert rel(res.x.numpy(), jres.x) <= 1e-10


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_cg_fused_tracks_single_reduce(dtype):
    op = laplace3d(16, 16, 8, dtype=dtype, fmt="stencil")
    b = torch.from_numpy(np.random.default_rng(4).standard_normal(
        op.n_rows_pad).astype(dtype))
    res_f = cg_fused(op, b, rtol=1e-5, maxiter=400)
    res_u = cg_single_reduce(lambda v: spmv(op, v), b, rtol=1e-5,
                             maxiter=400)
    assert bool(res_f.converged) and bool(res_u.converged)
    assert abs(res_f.iters - res_u.iters) <= 1
    assert rel(res_f.x.numpy(), res_u.x.numpy()) <= (
        1e-9 if dtype == np.float64 else 1e-4)
    assert cg_fused_iteration.launches == 0


def test_fused_cg_entry():
    step, (b,) = fused_cg_entry(dtype=np.float64, device="cpu")
    assert b.shape == (4096,) and float(b.abs().sum()) > 0
    res = step(b)
    assert bool(res.converged) and 10 < res.iters < 200
    true = torch.linalg.vector_norm(b - spmv(laplace3d(
        16, 16, 16, fmt="stencil"), res.x)) / torch.linalg.vector_norm(b)
    assert float(true) <= 1e-5


def test_error_paths():
    padded = laplace3d(12, 10, 6, dtype=np.float32, fmt="stencil")
    assert padded.n_rows_pad > padded.n_rows
    assert not cg_fused_applicable(padded)
    assert cg_fused_applicable(laplace3d(8, 8, 16, fmt="stencil"))
    assert not cg_fused_applicable(laplace3d(8, 8, 16))  # CSR, not stencil
    v = torch.zeros(padded.n_rows_pad)
    scal = torch.zeros((1, 4))
    with pytest.raises(ValueError, match="pad rows"):
        cg_fused_iteration(padded, v, v, v, v, v, scal)
    with pytest.raises(ValueError, match="pad rows"):
        cg_fused(padded, v)
    op = laplace3d(8, 8, 16, dtype=np.float32, fmt="stencil")
    u = torch.zeros(op.n_rows)
    with pytest.raises(ValueError, match="five vectors"):
        cg_fused_iteration(op, u, u, u, u, u[:-1], scal)
    with pytest.raises(ValueError, match="scal"):
        cg_fused_iteration(op, u, u, u, u, u, scal[:, :3])
    with pytest.raises(ValueError, match="scal"):
        cg_fused_iteration(op, u, u, u, u, u, scal.double())
