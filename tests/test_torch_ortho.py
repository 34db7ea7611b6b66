"""Port parity: the orthogonalization managers against the JAX package.

The same seeded numpy bases and blocks go through
``trilinos_tpu.solvers.ortho`` and ``trilinos_tpu_torch.solvers.ortho`` on
the CPU in f64. Tolerance: max|Δ| / max|ref| ≤ 1e-10 (the same algorithms,
summed by different BLAS); 1e-5 for the bf16-basis pass in f32. SVQB's
eigenvectors may differ in sign, so its q is compared through the projector
q·qᵀ. On rank-deficient panels CholQR's explicit inverse makes q NaN or
arbitrary in both packages, so ``rank_ok`` is compared, not q.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trilinos_tpu.parallel.comm import SerialComm as JComm
from trilinos_tpu.solvers import ortho as jo

from trilinos_tpu_torch.parallel.comm import SerialComm
from trilinos_tpu_torch.solvers import ortho as to

JC, TC = JComm(), SerialComm()
N = 240


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def basis(m, filled, seed):
    """(N, m) basis with ``filled`` orthonormal leading columns, the rest
    zero (the static-shape convention of the JAX package)."""
    q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal(
        (N, filled)))
    v = np.zeros((N, m))
    v[:, :filled] = q
    return v


def block(k, seed):
    return np.random.default_rng(seed).standard_normal((N, k))


def pair(fn_j, fn_t, *arrays, **kw):
    """Run the JAX and the port version of one function on the same
    arrays; returns (jax outputs as numpy, port outputs as numpy)."""
    jout = fn_j(JC, *(jnp.asarray(a) for a in arrays), **kw)
    tout = fn_t(TC, *(torch.from_numpy(a) for a in arrays), **kw)
    return ([np.asarray(o) for o in jout],
            [o.numpy() for o in tout])


def test_cgs2_matches_jax():
    v, w = basis(24, 16, seed=1), block(4, seed=2)
    (jw, jc), (tw, tc) = pair(jo.cgs2_project, to.cgs2_project, v, w)
    assert rel(tw, jw) <= 1e-10 and rel(tc, jc) <= 1e-10
    assert np.abs(v.T @ tw).max() <= 1e-12  # orthogonal to the basis
    np.testing.assert_array_equal(tc[16:], 0.0)  # unfilled columns add 0


@pytest.mark.parametrize("nearly_in_span", [False, True])
def test_dgks_both_branches_match_jax(nearly_in_span, monkeypatch):
    """A block nearly inside span(v) loses most of its norm in the first
    pass and takes the second; a random block does not."""
    v = basis(16, 16, seed=3)
    w = block(3, seed=4)
    if nearly_in_span:
        w = v @ np.random.default_rng(5).standard_normal((16, 3)) + 1e-6 * w
    passes = []
    inner = to.project_block
    monkeypatch.setattr(to, "project_block",
                        lambda *a: passes.append(1) or inner(*a))
    (jw, jc), (tw, tc) = pair(jo.dgks_project, to.dgks_project, v, w)
    assert len(passes) == (2 if nearly_in_span else 1)
    assert rel(tw, jw) <= 1e-10 and rel(tc, jc) <= 1e-10


def test_window_projection_equals_full_basis():
    """The prefix pass gives the full-basis pass's w and c, zero-padded."""
    v, w = basis(32, 13, seed=6), block(4, seed=7)
    tv, tw = torch.from_numpy(v), torch.from_numpy(w)
    full_w, full_c = to.cgs2_project(TC, tv, tw)
    win_w, win_c = to.cgs2_project_window(TC, tv, tw, 13, chunk=8)
    assert win_c.shape == full_c.shape == (32, 4)
    assert rel(win_w.numpy(), full_w.numpy()) <= 1e-12
    assert rel(win_c.numpy(), full_c.numpy()) <= 1e-12
    np.testing.assert_array_equal(win_c.numpy()[16:], 0.0)
    (jw, jc), (tw2, tc2) = pair(jo.cgs2_project_window,
                                to.cgs2_project_window, v, w, n_active=13,
                                chunk=8)
    assert rel(tw2, jw) <= 1e-10 and rel(tc2, jc) <= 1e-10
    (jw, jc), (tw3, tc3) = pair(jo.dgks_project_window,
                                to.dgks_project_window, v, w, n_active=13,
                                chunk=8)
    assert rel(tw3, jw) <= 1e-10 and rel(tc3, jc) <= 1e-10
    w0, c0 = to.project_block_window(TC, tv, tw, 0, chunk=8)
    assert w0 is tw and not c0.any()
    with pytest.raises(ValueError, match="multiple of chunk"):
        to.project_block_window(TC, tv, tw, 13, chunk=5)


def test_bf16_basis_matches_jax():
    v = basis(16, 16, seed=8).astype(np.float32)
    w = block(4, seed=9).astype(np.float32)
    jw, jc = jo.project_block(JC, jnp.asarray(v).astype(jnp.bfloat16),
                              jnp.asarray(w))
    tw, tc = to.project_block(TC, torch.from_numpy(v).to(torch.bfloat16),
                              torch.from_numpy(w))
    assert tw.dtype == tc.dtype == torch.float32
    assert rel(tw.numpy(), jw) <= 1e-5 and rel(tc.numpy(), jc) <= 1e-5


@pytest.mark.parametrize("fn", ["cholqr", "cholqr2"])
def test_cholqr_matches_jax(fn):
    w = block(6, seed=10) * np.array([1.0, 10.0, 0.1, 3.0, 1e-2, 1e2])
    (jq, jr, jok), (tq, tr, tok) = pair(getattr(jo, fn), getattr(to, fn), w)
    assert rel(tq, jq) <= 1e-10 and rel(tr, jr) <= 1e-10
    np.testing.assert_array_equal(tok, jok)
    assert tok.all()
    assert rel(tq.T @ tq, np.eye(6)) <= (1e-12 if fn == "cholqr2" else 1e-6)
    assert rel(tq @ tr, w) <= 1e-12
    np.testing.assert_array_equal(np.tril(tr, -1), 0.0)


def test_all_zero_panel():
    (jq, _, jok), (tq, _, tok) = pair(jo.cholqr, to.cholqr, np.zeros((N, 3)))
    np.testing.assert_array_equal(tq, 0.0)
    np.testing.assert_array_equal(jq, 0.0)
    assert not tok.any() and not jok.any()


def test_rank_deficient_panel_rank_ok():
    w = block(4, seed=11)
    w[:, 2] = 2.0 * w[:, 0]  # column 2 depends on column 0
    (_, _, jok), (_, _, tok) = pair(jo.cholqr2, to.cholqr2, w)
    np.testing.assert_array_equal(tok, jok)
    assert not tok[2] and tok[[0, 1, 3]].all()


def test_svqb_matches_jax():
    w = block(5, seed=12) * np.array([1.0, 1e3, 1e-3, 1.0, 10.0])
    (jq, jok), (tq, tok) = pair(jo.svqb, to.svqb, w)
    np.testing.assert_array_equal(tok, jok)
    assert rel(tq @ tq.T, jq @ jq.T) <= 1e-10
    assert rel(tq.T @ tq, np.eye(5)) <= 1e-10


def test_mgs_matches_jax():
    v, w = basis(12, 9, seed=13), block(3, seed=14)
    (jw, jc), (tw, tc) = pair(jo.mgs_project, to.mgs_project, v, w,
                              n_valid=9)
    assert rel(tw, jw) <= 1e-10 and rel(tc, jc) <= 1e-10
    np.testing.assert_array_equal(tc[9:], 0.0)


@pytest.mark.parametrize("method", ["CGS2", "DGKS", "MGS1", "IMGS"])
def test_project_and_normalize_matches_jax(method):
    v, w = basis(10, 10, seed=15), block(3, seed=16)
    jout, tout = pair(jo.project_and_normalize, to.project_and_normalize, v,
                      w, method=method)
    for name, j, t in zip(("q", "c", "r"), jout, tout):
        assert rel(t, j) <= 1e-10, name
    np.testing.assert_array_equal(tout[3], jout[3])
    with pytest.raises(ValueError, match="unknown ortho"):
        to.project_and_normalize(TC, torch.from_numpy(v),
                                 torch.from_numpy(w), method="QR")


def test_method_names_match_jax():
    assert to.valid_methods() == jo.valid_methods()
    for name in ("icgs", "CGS2", "dgks", "MGS", "MGS1", "IMGS"):
        assert to.resolve_method(name) == jo.resolve_method(name)
    with pytest.raises(ValueError, match="unknown orthogonalization"):
        to.resolve_method("householder")
    assert to.DGKS_DEP_TOL == pytest.approx(float(jo.DGKS_DEP_TOL), rel=1e-15)


@pytest.mark.parametrize("breakdown", [False, True])
def test_masked_lstsq_matches_jax(breakdown):
    rng = np.random.default_rng(17)
    h = np.triu(rng.standard_normal((9, 8)), -1)  # (m+1, m) Hessenberg
    if breakdown:
        h[:, 6:] = 0.0  # trailing columns numerically dependent
    rhs = rng.standard_normal(9)
    got = to.masked_lstsq(torch.from_numpy(h), torch.from_numpy(rhs)).numpy()
    want = np.asarray(jo.masked_lstsq(jnp.asarray(h), jnp.asarray(rhs)))
    assert rel(got, want) <= 1e-10
    if breakdown:
        np.testing.assert_array_equal(got[6:], 0.0)
    got2 = to.masked_lstsq(torch.from_numpy(h),
                           torch.from_numpy(rhs[:, None])).numpy()
    np.testing.assert_array_equal(got2[:, 0], got)
