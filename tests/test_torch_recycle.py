"""The port's recycling solvers (GCRO-DR, block GCRO-DR, RCG, PCPG) against
the JAX package's.

On ``recirc2d`` (diffusion 1e-2, nonsymmetric) and ``laplace2d``, stored as
DIA by both packages from one host matrix, the same seeded right-hand
sides go through both packages in f64: equal cycle or iteration counts, x
to 1e-10 (max|Δ| / max|x|), recycle spaces of equal size. A second solve
starts both packages from one recycle space (the JAX package's, carried
over by ``convert.recycle_space_from_numpy`` /
``cg_recycle_space_from_numpy``). The recycle basis: the port computes the
harmonic-Ritz coefficients P from H alone and forms U = V P on the device;
on the JAX package's own V and H, that U must equal the reference's
``u_np`` to 1e-12 (scalar and block). The returned spaces keep
A U = C and CᵀC = I.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trilinos_tpu.galeri import laplace2d as j_laplace2d
from trilinos_tpu.galeri import recirc2d as j_recirc2d
from trilinos_tpu.eigen import lanczos_eigs as j_lanczos_eigs
from trilinos_tpu.ops import formats as JF
from trilinos_tpu.ops import matvec as JS
from trilinos_tpu.parallel import SerialComm as JComm
from trilinos_tpu.solvers import block_gcrodr as j_block_gcrodr
from trilinos_tpu.solvers import gcrodr as j_gcrodr
from trilinos_tpu.solvers import pcpg as j_pcpg
from trilinos_tpu.solvers import rcg as j_rcg
from trilinos_tpu.solvers.block_gcrodr import (
    _block_cycle as j_block_cycle,
    _block_harmonic_recycle as j_block_harmonic)
from trilinos_tpu.solvers.gcrodr import _cycle as j_cycle
from trilinos_tpu.solvers.gcrodr import (
    _harmonic_ritz_recycle as j_harmonic)

from trilinos_tpu_torch.convert import (cg_recycle_space_from_numpy,
                                        recycle_space_from_numpy)
from trilinos_tpu_torch.ops import formats as TF
from trilinos_tpu_torch.ops import matvec as TS
from trilinos_tpu_torch.solvers import (LinearProblem, SolverManager,
                                        block_gcrodr, gcrodr, pcpg, rcg)
from trilinos_tpu_torch.solvers.block_gcrodr import _block_harmonic_coeffs
from trilinos_tpu_torch.solvers.gcrodr import _harmonic_ritz_coeffs
from torch_threads import one_thread  # noqa: F401  (autouse)

X_TOL = 1e-10


def _problem(a):
    ja = JF.csr_to_dia(a, dtype=np.float64)
    ta = TF.csr_to_dia(TF.CsrHost(a.row_ptr, a.cols, a.vals, a.shape),
                       device="cpu")
    return dict(a=a, npad=ja.n_rows_pad,
                jop=lambda x: JS.spmv(ja, x, impl="xla"),
                top=lambda x: TS.spmv(ta, x))


PROBLEMS = {"recirc2d": _problem(j_recirc2d(16, 16, diff=1e-2)),
            "laplace2d": _problem(j_laplace2d(16, 16))}


def rhs(name, k=None, seed=0):
    p = PROBLEMS[name]
    n = p["a"].shape[0]
    b = np.zeros((p["npad"],) if k is None else (p["npad"], k))
    b[:n] = np.random.default_rng(seed).standard_normal(b[:n].shape)
    return b


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def true_rel(name, b, x):
    a = PROBLEMS[name]["a"]
    n = a.shape[0]
    r = b[:n] - a.to_dense() @ np.asarray(x)[:n]
    return np.linalg.norm(r, axis=0) / np.linalg.norm(b[:n], axis=0)


def assert_same(tr, jr):
    assert int(tr.iters) == int(jr.iters)
    assert rel(tr.x.numpy(), jr.x) <= X_TOL
    np.testing.assert_array_equal(np.asarray(tr.converged),
                                  np.asarray(jr.converged))


def assert_space(op, rec, k):
    assert rec.size == k
    c = rec.c.numpy()
    np.testing.assert_allclose(c.T @ c, np.eye(k), atol=1e-10)
    np.testing.assert_allclose(op(rec.u).numpy(), c, atol=1e-8)


GCRODR_KW = dict(num_blocks=25, recycle_dim=6, rtol=1e-8)


def test_gcrodr_matches_jax_and_recycles():
    p = PROBLEMS["recirc2d"]
    b1, b2 = rhs("recirc2d", seed=0), rhs("recirc2d", seed=2)
    jr, jrec = j_gcrodr(p["jop"], jnp.asarray(b1), **GCRODR_KW)
    tr, trec = gcrodr(p["top"], torch.from_numpy(b1), **GCRODR_KW)
    assert_same(tr, jr)
    assert bool(tr.converged) and int(tr.iters) > 25  # several cycles
    assert true_rel("recirc2d", b1, tr.x) <= 1e-7
    assert_space(p["top"], trec, 6)
    # each package reuses its own space
    jr2, _ = j_gcrodr(p["jop"], jnp.asarray(b2), recycle=jrec, **GCRODR_KW)
    tr2, _ = gcrodr(p["top"], torch.from_numpy(b2), recycle=trec,
                    **GCRODR_KW)
    assert_same(tr2, jr2)
    # both from the JAX package's space
    shared = recycle_space_from_numpy(np.asarray(jrec.u), np.asarray(jrec.c),
                                      device="cpu")
    tr3, _ = gcrodr(p["top"], torch.from_numpy(b2), recycle=shared,
                    **GCRODR_KW)
    assert_same(tr3, jr2)


def test_gcrodr_right_preconditioned_matches_jax():
    p = PROBLEMS["recirc2d"]
    b = rhs("recirc2d", seed=3)
    d = np.ones(p["npad"])
    d[:p["a"].shape[0]] = 1.0 / p["a"].diagonal()
    jd, td = jnp.asarray(d), torch.from_numpy(d)
    # the recycle space's set-up applies A∘M to the (n, k) basis
    jr, _ = j_gcrodr(p["jop"], jnp.asarray(b), prec=lambda v: (
        jd if v.ndim == 1 else jd[:, None]) * v, **GCRODR_KW)
    tr, trec = gcrodr(p["top"], torch.from_numpy(b), prec=lambda v: (
        td if v.ndim == 1 else td[:, None]) * v, **GCRODR_KW)
    assert_same(tr, jr)
    assert trec.size == 6


def test_recycle_basis_from_h_alone():
    """U = V[:, :m] P with P from H alone equals the reference's u_np
    (V pulled to the host) on the JAX package's own first cycle."""
    p = PROBLEMS["recirc2d"]
    b = jnp.asarray(rhs("recirc2d"))
    m, k = 20, 6
    zeros = jnp.zeros((b.shape[0], k))
    _, _, v, h = j_cycle(p["jop"], m, JComm(), b, jnp.zeros_like(b), zeros,
                         zeros, False)
    v_np, h_np = np.asarray(v), np.asarray(h)
    want = j_harmonic(v_np, h_np, k)
    got = (torch.from_numpy(v_np[:, :m])
           @ torch.from_numpy(_harmonic_ritz_coeffs(h_np, k))).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_block_recycle_basis_from_h_alone():
    p = PROBLEMS["recirc2d"]
    b = jnp.asarray(rhs("recirc2d", 3))
    m, k = 8, 6
    zeros = jnp.zeros((b.shape[0], k))
    _, _, v, h = j_block_cycle(p["jop"], m, JComm(), b, jnp.zeros_like(b),
                               zeros, zeros, False)
    v_np, h_np = np.asarray(v), np.asarray(h)
    want = j_block_harmonic(v_np, h_np, k)
    got = (torch.from_numpy(v_np[:, :m * 3])
           @ torch.from_numpy(_block_harmonic_coeffs(h_np, k))).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_block_gcrodr_matches_jax_and_recycles():
    """On laplace2d, four cycles a solve. (On recirc2d a solve of many
    cycles amplifies the packages' rounding differences: after 37 cycles
    of 10 block steps, with equal cycle counts, x is 1.5e-8 apart.)"""
    p = PROBLEMS["laplace2d"]
    b1, b2 = rhs("laplace2d", 3, seed=0), rhs("laplace2d", 3, seed=4)
    kw = dict(num_blocks=15, recycle_dim=6, rtol=1e-8)
    jr, jrec = j_block_gcrodr(p["jop"], jnp.asarray(b1), **kw)
    tr, trec = block_gcrodr(p["top"], torch.from_numpy(b1), **kw)
    assert_same(tr, jr)
    assert bool(tr.converged.all()) and tr.iters > 15
    assert (true_rel("laplace2d", b1, tr.x) <= 1e-7).all()
    assert_space(p["top"], trec, 6)
    jr2, _ = j_block_gcrodr(p["jop"], jnp.asarray(b2), recycle=jrec, **kw)
    shared = recycle_space_from_numpy(np.asarray(jrec.u), np.asarray(jrec.c),
                                      device="cpu")
    tr2, _ = block_gcrodr(p["top"], torch.from_numpy(b2), recycle=shared,
                          **kw)
    assert_same(tr2, jr2)


def test_block_gcrodr_rejects_one_column():
    with pytest.raises(ValueError, match="2-D"):
        block_gcrodr(PROBLEMS["recirc2d"]["top"],
                     torch.from_numpy(rhs("recirc2d")))


def test_rcg_matches_jax_and_recycles():
    p = PROBLEMS["laplace2d"]
    b1, b2 = rhs("laplace2d", seed=1), rhs("laplace2d", seed=2)
    jr, jrec = j_rcg(p["jop"], jnp.asarray(b1), recycle_dim=6, rtol=1e-8)
    tr, trec = rcg(p["top"], torch.from_numpy(b1), recycle_dim=6, rtol=1e-8)
    assert_same(tr, jr)
    assert trec.size == 6 and bool(tr.converged)
    assert true_rel("laplace2d", b1, tr.x) <= 1.1e-8
    jr2, _ = j_rcg(p["jop"], jnp.asarray(b2), recycle_dim=6, rtol=1e-8,
                   recycle=jrec)
    tr2, _ = rcg(p["top"], torch.from_numpy(b2), recycle_dim=6, rtol=1e-8,
                 recycle=trec)
    assert_same(tr2, jr2)
    shared = cg_recycle_space_from_numpy(np.asarray(jrec.u), device="cpu")
    tr3, _ = rcg(p["top"], torch.from_numpy(b2), recycle_dim=6, rtol=1e-8,
                 recycle=shared)
    assert_same(tr3, jr2)


def test_rcg_preconditioned_matches_jax():
    p = PROBLEMS["laplace2d"]
    b = rhs("laplace2d", seed=5)
    jr, _ = j_rcg(p["jop"], jnp.asarray(b), recycle_dim=8, rtol=1e-9,
                  prec=lambda v: 0.25 * v)
    tr, _ = rcg(p["top"], torch.from_numpy(b), recycle_dim=8, rtol=1e-9,
                prec=lambda v: 0.25 * v)
    assert_same(tr, jr)


def test_pcpg_matches_jax():
    p = PROBLEMS["laplace2d"]
    b = rhs("laplace2d", seed=3)
    _, u = j_lanczos_eigs(p["jop"], jnp.asarray(b), nev=4, m=40, which="SA")
    u = np.asarray(u)
    jr = j_pcpg(p["jop"], jnp.asarray(b), jnp.asarray(u), rtol=1e-8,
                maxiter=2000)
    tr = pcpg(p["top"], torch.from_numpy(b), torch.from_numpy(u), rtol=1e-8,
              maxiter=2000)
    assert_same(tr, jr)
    assert true_rel("laplace2d", b, tr.x) <= 1.1e-8


def test_manager_keeps_the_recycle_space():
    """Through the factory: GCRODR, Block GCRODR (one column: GCRO-DR) and
    RCG keep their space on the manager for the next solve."""
    p = PROBLEMS["recirc2d"]
    b = torch.from_numpy(rhs("recirc2d"))
    for name in ("GCRODR", "Block GCRODR"):
        mgr = SolverManager(name, {"Num Blocks": 25,
                                   "Num Recycled Blocks": 6})
        r1 = mgr.solve(LinearProblem(p["top"], b))
        assert mgr.recycle_space.size == 6
        r2 = mgr.solve(LinearProblem(p["top"], b))
        assert bool(r1.converged) and bool(r2.converged)
        assert r2.iters <= r1.iters
    q = PROBLEMS["laplace2d"]
    mgr = SolverManager("RCG", {"Num Recycled Blocks": 6})
    mgr.solve(LinearProblem(q["top"], torch.from_numpy(rhs("laplace2d"))))
    assert mgr.cg_recycle_space.size == 6
