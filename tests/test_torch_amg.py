"""Port parity: the structured SA-AMG hierarchy and its cycles.

Both packages build the hierarchy of the same Laplace3D 16³ and Laplace2D
32² stencils in f64; the level operators, Jacobi diagonals and coarse
inverse must agree to 1e-12. The JAX hierarchy's ``state()`` is then
carried into the port with ``amg_state_from_jax`` and both apply it to the
same seeded vectors (max|Δ| / max|y| ≤ 1e-12).
"""
import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trilinos_tpu.galeri import laplace2d as j_laplace2d
from trilinos_tpu.galeri import laplace3d as j_laplace3d
from trilinos_tpu.precond import SaAmg as JSaAmg

from trilinos_tpu_torch.convert import amg_state_from_jax
from trilinos_tpu_torch.galeri import laplace2d, laplace3d
from trilinos_tpu_torch.ops import DiaMatrix, StencilOp
from trilinos_tpu_torch.precond import SaAmg
from trilinos_tpu_torch.precond.amg import (_structured_transfers,
                                            block_pair_dup, block_pair_sum)
from torch_threads import one_thread  # noqa: F401  (autouse)

GRIDS = {"3d": ((16, 16, 16), j_laplace3d, laplace3d),
         "2d": ((32, 32), j_laplace2d, laplace2d)}


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def rand_vec(npad, n, seed, k=None):
    tail = () if k is None else (k,)
    v = np.zeros((npad,) + tail)
    v[:n] = np.random.default_rng(seed).standard_normal((n,) + tail)
    return v


@pytest.fixture(scope="module", params=sorted(GRIDS))
def pair(request):
    """(grid, JAX SaAmg, port SaAmg, numpy JAX state), V-cycle, f64."""
    dims, jgen, tgen = GRIDS[request.param]
    jm = JSaAmg(jgen(*dims, fmt="stencil")).compute()
    tm = SaAmg(tgen(*dims, fmt="stencil"), device="cpu").compute()
    np_state = jax.tree_util.tree_map(np.asarray, jm.state())
    return request.param, jm, tm, np_state


def test_hierarchy_matches_jax(pair):
    _, jm, tm, _ = pair
    assert tm.n_levels() == jm.n_levels()
    assert isinstance(tm.levels[0]["a"], StencilOp)
    for jl, tl in zip(jm.levels, tm.levels, strict=True):
        for key in ("dims", "block", "n_f", "n_c"):
            assert tl[key] == jl[key]
        assert tl["omega"] == pytest.approx(jl["omega"], rel=1e-14)
        np.testing.assert_allclose(tl["dinv"].numpy(),
                                   np.asarray(jl["dinv"]), rtol=1e-12)
        ja, ta = jl["a"], tl["a"]
        if isinstance(ta, StencilOp):
            assert (ta.dims, ta.offsets, ta.coeffs, ta.n_rows_pad) == (
                ja.dims, ja.offsets, ja.coeffs, ja.n_rows_pad)
        else:
            assert isinstance(ta, DiaMatrix)
            assert ta.offsets == ja.offsets
            assert ta.n_rows_pad == ja.n_rows_pad
            np.testing.assert_allclose(ta.data.numpy(),
                                       np.asarray(ja.data_flat),
                                       rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tm.coarse_inv.numpy(),
                               np.asarray(jm.coarse_inv), rtol=1e-12,
                               atol=1e-12)


def test_transfers_are_adjoint(pair):
    _, _, tm, _ = pair
    lvl = tm.levels[0]
    restrict, prolong = _structured_transfers(
        lvl["a"], lvl["dims"], lvl["n_c"], lvl["block"], lvl["omega"],
        lvl["dinv"])
    n_f = int(np.prod(lvl["dims"]))
    n_c = n_f // int(np.prod(lvl["block"]))
    w = torch.from_numpy(rand_vec(lvl["n_f"], n_f, 3))
    vc = torch.from_numpy(rand_vec(lvl["n_c"], n_c, 4))
    s1 = float(torch.dot(vc, restrict(w)))
    s2 = float(torch.dot(w, prolong(vc)))
    assert abs(s1 - s2) <= 1e-12 * abs(s1)
    # the block sum and the block broadcast are exact adjoints
    dims, block = lvl["dims"], lvl["block"]
    cdims = tuple(d // b for d, b in zip(dims, block))
    u = torch.from_numpy(rand_vec(n_f, n_f, 5))
    e = torch.from_numpy(rand_vec(n_c, n_c, 6))
    assert abs(float(torch.dot(e, block_pair_sum(u, dims, block)))
               - float(torch.dot(block_pair_dup(e, cdims, block), u))) \
        <= 1e-12 * float(u.abs().sum() * e.abs().max())


def test_vcycle_apply_state_matches_jax(pair):
    grid, jm, tm, np_state = pair
    dims = GRIDS[grid][0]
    st = amg_state_from_jax(np_state, dims, device="cpu")
    npad, n = tm.levels[0]["n_f"], int(np.prod(dims))
    r = rand_vec(npad, n, 7)
    want = np.asarray(jm.apply_state(jm.state(), jnp.asarray(r)))
    got = tm.apply_state(st, torch.from_numpy(r)).numpy()
    assert rel(got, want) <= 1e-12
    # the port's own hierarchy and apply() give the same result
    assert rel(tm.apply(torch.from_numpy(r)).numpy(), want) <= 1e-12
    # symmetric, as CG needs
    v = torch.from_numpy(rand_vec(npad, n, 8))
    w = torch.from_numpy(rand_vec(npad, n, 9))
    s1, s2 = float(torch.dot(v, tm.apply(w))), float(torch.dot(w, tm.apply(v)))
    assert abs(s1 - s2) <= 1e-12 * abs(s1)


def test_multivector_apply_matches_columns(pair):
    grid, _, tm, _ = pair
    npad, n = tm.levels[0]["n_f"], int(np.prod(GRIDS[grid][0]))
    rk = torch.from_numpy(rand_vec(npad, n, 10, k=2))
    yk = tm.apply(rk)
    for c in range(2):
        assert rel(yk[:, c].numpy(),
                   tm.apply(rk[:, c].contiguous()).numpy()) <= 1e-14


def test_wcycle_apply_state_matches_jax():
    dims = (16, 16, 16)
    jm = JSaAmg(j_laplace3d(*dims, fmt="stencil"),
                {"cycle type": "W"}).compute()
    tm = SaAmg(laplace3d(*dims, fmt="stencil"), {"cycle type": "W"},
               device="cpu").compute()
    st = amg_state_from_jax(jax.tree_util.tree_map(np.asarray, jm.state()),
                            dims, device="cpu")
    r = rand_vec(tm.levels[0]["n_f"], 4096, 11)
    want = np.asarray(jm.apply_state(jm.state(), jnp.asarray(r)))
    assert rel(tm.apply_state(st, torch.from_numpy(r)).numpy(), want) \
        <= 1e-12
    with pytest.raises(ValueError, match="expected grid"):
        amg_state_from_jax(jax.tree_util.tree_map(np.asarray, jm.state()),
                           (16, 16, 8), device="cpu")


def test_unported_branches_raise():
    op = laplace3d(8, 8, 8, fmt="stencil")
    # the uncoupled branch is ported (tests/test_torch_uncoupled_amg.py); as
    # in the reference, it takes a stored matrix, not a bare StencilOp
    with pytest.raises(TypeError, match="CsrHost"):
        SaAmg(op, {"aggregation: type": "uncoupled"}, device="cpu").compute()
    with pytest.raises(TypeError, match="CsrHost"):
        SaAmg(op, {"aggregation: type": "uncoupled",
                   "smoother: type": "chebyshev"}, device="cpu").compute()
    with pytest.raises(ValueError, match="even dim"):
        SaAmg(laplace2d(9, 9, fmt="stencil"),
              {"aggregation: type": "structured"}, device="cpu").compute()
    with pytest.raises(ValueError, match="unknown parameters"):
        SaAmg(op, {"smoother: sweep": 3}, device="cpu").compute()
    with pytest.raises(RuntimeError, match="before compute"):
        SaAmg(op, device="cpu").apply(torch.zeros(op.n_rows_pad))
