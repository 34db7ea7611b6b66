"""The host half of the port's distributed layer against the JAX package's:
maps, partitioners, halo plans, the distributed matrices' per-rank arrays,
the distributed set-up's blocks, values-only refill, the native ghost
ordering and the distributed preconditioners' state. No process is
spawned and no JAX program is compiled.

Everything here is host numpy on both sides, built from the same seeded
inputs, so the arrays must be equal (``assert_array_equal``); the
products of the distributed set-up run through each package's own native
SpGEMM and are held to 1e-14 relative (summation order).
"""
import numpy as np
import pytest

import jax

from trilinos_tpu.galeri import laplace2d as jlaplace2d
from trilinos_tpu.galeri import laplace3d as jlaplace3d
from trilinos_tpu.ops import formats as F
from trilinos_tpu.parallel import dist_setup as jds
from trilinos_tpu.parallel import distmatrix as JD
from trilinos_tpu.parallel import driver as jdrv
from trilinos_tpu.parallel import map as jmap
from trilinos_tpu.parallel import partition as jpart
from trilinos_tpu_torch import convert
from trilinos_tpu_torch.galeri import laplace2d, laplace3d
from trilinos_tpu_torch.ops.formats import BsrMatrix, CsrHost, DiaMatrix
from trilinos_tpu_torch.parallel import dist_setup as ds
from trilinos_tpu_torch.parallel import distmatrix as D
from trilinos_tpu_torch.parallel import driver as drv
from trilinos_tpu_torch.parallel import map as tmap
from trilinos_tpu_torch.parallel import partition as tpart

import torch_dist_tasks as T
from torch_threads import one_thread  # noqa: F401  (autouse)

SETUP_RTOL = 1e-14
PLAN_FIELDS = ("send_idx", "send_valid", "recv_sel", "ghost_valid")


def jcsr(a):
    return F.CsrHost(a.row_ptr, a.cols, a.vals, a.shape)


def same_csr(got, want, rtol=0.0):
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.row_ptr, want.row_ptr)
    np.testing.assert_array_equal(got.cols, want.cols)
    np.testing.assert_allclose(got.vals, want.vals, rtol=rtol, atol=0)


def interior_arrays(m):
    """The numpy arrays of a port interior, in the JAX package's layout."""
    if isinstance(m, DiaMatrix):
        return [m.data.numpy()]
    if isinstance(m, BsrMatrix):
        return [m.bcols.numpy(), m.bvals.numpy()]
    return [m.cols.numpy(), m.vals.numpy()]


def jax_interior_arrays(it, s):
    if hasattr(it, "offsets"):
        d = np.asarray(it.data)[s]
        return [d.reshape(d.shape[0], -1)]
    if hasattr(it, "bcols"):
        return [np.asarray(it.bcols)[s], np.asarray(it.bvals)[s]]
    return [np.asarray(it.cols)[s], np.asarray(it.vals)[s]]


def same_dist(got, want):
    """Every rank's arrays of a port DistMatrix equal the JAX one's."""
    assert got.plan.mode == want.plan.mode
    assert got.plan.offsets == want.plan.offsets
    assert (got.plan.seg, got.plan.n_ghost_pad) == (want.plan.seg,
                                                    want.plan.n_ghost_pad)
    for f in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(got.plan, f),
                                      np.asarray(getattr(want.plan, f)))
    for f in ("rows_idx", "cols", "vals"):
        np.testing.assert_array_equal(getattr(got.boundary, f),
                                      np.asarray(getattr(want.boundary, f)))
    assert got.row_map == tmap.Map(**vars(want.row_map))
    for s, it in enumerate(got.interior):
        if hasattr(want.interior, "offsets"):
            assert it.offsets == want.interior.offsets
        for g, w in zip(interior_arrays(it),
                        jax_interior_arrays(want.interior, s), strict=True):
            np.testing.assert_array_equal(g, w)


# -- maps ---------------------------------------------------------------------

@pytest.mark.parametrize("n,p", [(100, 4), (7, 3), (1000, 8), (5, 8)])
def test_uniform_map_matches_jax(n, p):
    got, want = tmap.Map.uniform(n, p), jmap.Map.uniform(n, p)
    assert got == tmap.Map(**vars(want))
    gids = np.arange(n)
    np.testing.assert_array_equal(got.owner_of(gids), want.owner_of(gids))
    x = np.random.default_rng(0).standard_normal((n, 2))
    np.testing.assert_array_equal(got.to_padded(x), want.to_padded(x))
    np.testing.assert_array_equal(got.from_padded(got.to_padded(x)), x)
    for s in range(p):
        assert (got.shard_lo(s), got.shard_hi(s)) == (want.shard_lo(s),
                                                      want.shard_hi(s))


def test_contiguous_map_and_directory_match_jax():
    sizes = [5, 0, 9, 3]
    got, want = tmap.Map.contiguous(sizes), jmap.Map.contiguous(sizes)
    assert got == tmap.Map(**vars(want))
    gids = np.arange(got.n_global)
    np.testing.assert_array_equal(got.owner_of(gids), want.owner_of(gids))
    np.testing.assert_array_equal(got.gid_to_lid(gids[9:], 2),
                                  want.gid_to_lid(gids[9:], 2))
    perm = np.random.default_rng(1).permutation(got.n_global)
    d_got = tmap.Directory(map=got, new_of_old=perm)
    d_want = jmap.Directory(map=want, new_of_old=perm)
    for g, w in zip(d_got.remote_index_list(gids),
                    d_want.remote_index_list(gids)):
        np.testing.assert_array_equal(g, w)


# -- partitioners ---------------------------------------------------------------

def _coords(n, d, seed):
    return np.random.default_rng(seed).standard_normal((n, d))


@pytest.mark.parametrize("parts", [2, 3, 5, 8])
def test_partition_rcb_matches_jax(parts):
    c = _coords(200, 3, parts)
    np.testing.assert_array_equal(tpart.partition_rcb(c, parts),
                                  jpart.partition_rcb(c, parts))


@pytest.mark.parametrize("ppd", [(2, 2), (3, 1, 2), (4,)])
def test_partition_multijagged_matches_jax(ppd):
    c = _coords(150, 3, 11)
    np.testing.assert_array_equal(tpart.partition_multijagged(c, ppd),
                                  jpart.partition_multijagged(c, ppd))


GRAPHS = {"laplace2d": (laplace2d(9, 7), jlaplace2d(9, 7)),
          "nonsym": (T.nonsym_csr(5, 60), jcsr(T.nonsym_csr(5, 60)))}


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_graph_partitioners_and_orderings_match_jax(graph):
    a, ja = GRAPHS[graph]
    part = tpart.partition_greedy_graph(a, 4)
    np.testing.assert_array_equal(part, jpart.partition_greedy_graph(ja, 4))
    np.testing.assert_array_equal(tpart.partition_to_permutation(part),
                                  jpart.partition_to_permutation(part))
    assert tpart.partition_quality(a, part) == jpart.partition_quality(
        ja, part)
    np.testing.assert_array_equal(tpart.order_rcm(a), jpart.order_rcm(ja))
    np.testing.assert_array_equal(tpart.color_distance2(a),
                                  jpart.color_distance2(ja))
    np.testing.assert_array_equal(tpart.partition_lines(a, 3),
                                  jpart.partition_lines(ja, 3))
    perm = tpart.order_rcm(a)
    same_csr(tpart.permute_csr(a, perm), jpart.permute_csr(ja, perm))


# -- halo plans and distributed matrices ---------------------------------------

def _ghosts(a, rmap):
    """Owner-major gid-sorted ghost columns of every rank."""
    out = []
    for s in range(rmap.n_shards):
        lo, hi = rmap.shard_lo(s), rmap.shard_hi(s)
        c = a.cols[a.row_ptr[lo]:a.row_ptr[hi]].astype(np.int64)
        out.append(np.unique(c[(c < lo) | (c >= hi)]))
    return out


@pytest.mark.parametrize("p", [2, 4, 8])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_build_halo_plans_match_jax(p, graph):
    a, _ = GRAPHS[graph]
    rmap = tmap.Map.uniform(a.shape[0], p)
    ghosts = _ghosts(a, rmap)
    got, got_sends = D.build_halo_plans(ghosts, rmap, p)
    want, want_sends = JD.build_halo_plans(
        ghosts, jmap.Map.uniform(a.shape[0], p), p)
    for g, w in zip(got, want, strict=True):
        assert (g.mode, g.offsets, g.seg, g.n_ghost_pad) == (
            w.mode, w.offsets, w.seg, w.n_ghost_pad)
        for f in PLAN_FIELDS:
            np.testing.assert_array_equal(getattr(g, f),
                                          np.asarray(getattr(w, f)))
    for gs, ws in zip(got_sends, want_sends):
        for g, w in zip(gs, ws):
            np.testing.assert_array_equal(g, w)
    # the four-offset rule: the random matrix needs all-to-all at 8 ranks
    assert got[0].mode == ("a2a" if (graph, p) == ("nonsym", 8)
                           else "ppermute")


@pytest.mark.parametrize("p", [2, 4, 8])
@pytest.mark.parametrize("fmt", ["auto", "dia", "ell"])
def test_distribute_matches_jax(p, fmt):
    a = laplace2d(12, 11)
    same_dist(D.distribute(a, p, fmt=fmt, debug=True),
              JD.distribute(jcsr(a), p, fmt=fmt))


@pytest.mark.parametrize("p", [2, 4])
def test_distribute_bsr_matches_jax(p):
    a = laplace2d(8, 8)
    same_dist(D.distribute(a, p, fmt="bsr", block_size=2),
              JD.distribute(jcsr(a), p, fmt="bsr", block_size=2))


def test_distribute_auto_picks_ell_past_32_diagonals():
    a = T.nonsym_csr(6, 120, density=0.3)
    dm = D.distribute(a, 4)
    same_dist(dm, JD.distribute(jcsr(a), 4))
    assert not isinstance(dm.interior[0], DiaMatrix)


@pytest.mark.parametrize("p", [2, 4])
def test_distribute_blocks_and_partitioned_match_jax(p):
    a = laplace2d(10, 9)
    rmap = tmap.Map.uniform(a.shape[0], p)
    jrmap = jmap.Map.uniform(a.shape[0], p)
    same_dist(D.distribute_blocks(ds.split_rows(a, rmap), rmap),
              JD.distribute_blocks(jds.split_rows(jcsr(a), jrmap), jrmap))
    got, gdir = D.distribute_partitioned(a, p)
    want, wdir = JD.distribute_partitioned(jcsr(a), p)
    same_dist(got, want)
    np.testing.assert_array_equal(gdir.new_of_old, wdir.new_of_old)


@pytest.mark.parametrize("p", [2, 4])
def test_distribute_rect_matches_jax(p):
    a = T.nonsym_csr(7, 40)
    rect = F.CsrHost(a.row_ptr, a.cols % 25, a.vals, (40, 25))
    t_rect = CsrHost(rect.row_ptr, rect.cols, rect.vals, rect.shape)
    rows = tmap.Map.uniform(40, p)
    cols = tmap.Map.uniform(25, p)
    got = D.distribute_rect(t_rect, rows, cols)
    want = JD.distribute_rect(rect, jmap.Map.uniform(40, p),
                              jmap.Map.uniform(25, p))
    same_dist(got, want)
    assert got.col_map == tmap.Map(**vars(want.col_map))


@pytest.mark.parametrize("p,depth", [(2, None), (4, None), (4, 3)])
def test_distribute_stencil_matches_jax(p, depth):
    dims = (6, 4, 12)
    got = D.distribute_stencil(laplace3d(*dims, fmt="stencil"), p, depth)
    want = JD.distribute_stencil(jlaplace3d(*dims, fmt="stencil"), p, depth)
    assert got.depth == want.depth
    assert got.op_local.dims == want.op_local.dims
    for f in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(got.plan, f),
                                      np.asarray(getattr(want.plan, f)))
    np.testing.assert_array_equal(got.sel, np.asarray(want.sel))
    np.testing.assert_array_equal(got.valid, np.asarray(want.valid))
    np.testing.assert_array_equal(
        D.zslab_bounds(laplace3d(*dims, fmt="stencil"), p, got.depth),
        JD.zslab_bounds(jlaplace3d(*dims, fmt="stencil"), p, want.depth))


def test_native_ghost_slots_match_the_numpy_path(monkeypatch):
    from trilinos_tpu_torch import native

    real = native.ghost_slots_native
    a = T.nonsym_csr(8, 90)
    D._ghost_slots.native_calls = D._ghost_slots.numpy_calls = 0
    nat = D.distribute(a, 4)
    assert D._ghost_slots.native_calls == 4
    monkeypatch.setattr(native, "ghost_slots_native", lambda cols: None)
    host = D.distribute(a, 4)
    assert D._ghost_slots.numpy_calls == 4
    for f in ("rows_idx", "cols", "vals"):
        np.testing.assert_array_equal(getattr(nat.boundary, f),
                                      getattr(host.boundary, f))
    for f in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(nat.plan, f),
                                      getattr(host.plan, f))
    cols = np.random.default_rng(2).integers(0, 50, 200)
    gids, slots = real(cols)
    np.testing.assert_array_equal(gids, np.unique(cols))
    np.testing.assert_array_equal(gids[slots], cols)


# -- values-only refill -----------------------------------------------------------

@pytest.mark.parametrize("fmt", ["dia", "ell", "bsr"])
def test_refill_matches_jax_and_builds_no_plan(fmt):
    a = laplace2d(8, 8)
    kw = dict(block_size=2) if fmt == "bsr" else {}
    dm = D.distribute(a, 4, fmt=fmt, **kw)
    jdm = JD.distribute(jcsr(a), 4, fmt=fmt, **kw)
    plan = D.build_refill(a, dm)
    jplan = JD.build_refill(jcsr(a), jdm)
    new = np.random.default_rng(3).standard_normal(a.nnz)
    before = D.PLAN_BUILD_COUNT
    got = D.refill_values(dm, plan, new)
    assert D.PLAN_BUILD_COUNT == before
    same_dist(got, jax.tree_util.tree_map(
        np.asarray, JD.refill_values(jdm, jplan, new)))
    fresh = D.distribute(CsrHost(a.row_ptr, a.cols, new, a.shape), 4,
                         fmt=fmt, **kw)
    for g, w in zip(D._value_arrays(got), D._value_arrays(fresh)):
        np.testing.assert_array_equal(g, w)


# -- distributed set-up ---------------------------------------------------------

def _split(p):
    a = laplace3d(8, 6, 4)
    rmap = tmap.Map.uniform(a.shape[0], p)
    jrmap = jmap.Map.uniform(a.shape[0], p)
    return (a, rmap, ds.split_rows(a, rmap), jrmap,
            jds.split_rows(jcsr(a), jrmap))


@pytest.mark.parametrize("p", [2, 4])
def test_dist_setup_products_match_jax(p):
    a, rmap, blocks, jrmap, jblocks = _split(p)
    for g, w in zip(blocks, jblocks, strict=True):
        same_csr(g, w)
    for g, w in zip(ds.spgemm_blocks(blocks, rmap, blocks, rmap),
                    jds.spgemm_blocks(jblocks, jrmap, jblocks, jrmap)):
        same_csr(g, w, SETUP_RTOL)
    for g, w in zip(ds.transpose_blocks(blocks, rmap, rmap),
                    jds.transpose_blocks(jblocks, jrmap, jrmap)):
        same_csr(g, w)
    same_csr(ds.concat_rows(blocks), jds.concat_rows(jblocks))


@pytest.mark.parametrize("p", [2, 4])
def test_dist_hierarchy_matches_jax(p):
    _, rmap, blocks, jrmap, jblocks = _split(p)
    got, g_coarse, g_map = ds.build_dist_hierarchy(blocks, rmap,
                                                   coarse_max=16)
    want, w_coarse, w_map = jds.build_dist_hierarchy(jblocks, jrmap,
                                                     coarse_max=16)
    assert len(got) == len(want) and len(got) >= 1
    assert g_map == tmap.Map(**vars(w_map))
    for (ga, gm, gp, gc, gd), (wa, wm, wp, wc, wd) in zip(got, want):
        assert (gm, gc) == (tmap.Map(**vars(wm)), tmap.Map(**vars(wc)))
        for g, w in zip(ga + gp, wa + wp):
            same_csr(g, w, SETUP_RTOL)
        for g, w in zip(gd, wd):
            np.testing.assert_allclose(g, w, rtol=SETUP_RTOL)
    for g, w in zip(g_coarse, w_coarse):
        same_csr(g, w, SETUP_RTOL)
    for g, w in zip(ds.rap_blocks(blocks, rmap, got[0][2], got[0][3]),
                    jds.rap_blocks(jblocks, jrmap, want[0][2], want[0][3])):
        same_csr(g, w, SETUP_RTOL)


# -- preconditioner state and the conversion ------------------------------------

@pytest.mark.parametrize("kind", ["jacobi", "ilu0"])
def test_dist_precond_state_matches_jax(kind):
    a = laplace2d(10, 9)
    rmap = tmap.Map.uniform(a.shape[0], 4)
    jrmap = jmap.Map.uniform(a.shape[0], 4)
    fn, jfn = ((drv.dist_jacobi, jdrv.dist_jacobi) if kind == "jacobi"
               else (drv.dist_ilu0, jdrv.dist_ilu0))
    got, want = fn(a, rmap), jfn(jcsr(a), jrmap)
    assert got.kind == want.kind and got.consts == want.consts
    assert sorted(got.arrays) == sorted(want.arrays)
    for k, v in got.arrays.items():
        np.testing.assert_array_equal(v, np.asarray(want.arrays[k]))


def test_dist_amg_levels_match_jax():
    a = laplace3d(8, 6, 4)
    rmap = tmap.Map.uniform(a.shape[0], 4)
    got = drv.dist_amg(a, rmap, coarse_max=16)
    want = jdrv.dist_amg(jcsr(a), jmap.Map.uniform(a.shape[0], 4),
                         coarse_max=16)
    assert got.consts == want.consts
    for g, w in zip(got.arrays["levels"], want.arrays["levels"],
                    strict=True):
        for key in ("a", "p", "r"):
            same_dist(g[key], w[key])
        np.testing.assert_array_equal(g["dinv"], np.asarray(w["dinv"]))
    np.testing.assert_array_equal(got.replicated["coarse_pos"],
                                  np.asarray(want.arrays["coarse_pos"])[0])
    np.testing.assert_allclose(got.replicated["coarse_inv"],
                               np.asarray(want.arrays["coarse_inv"])[0],
                               rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("what", ["matrix", "stencil", "amg", "cheb_fused"])
def test_convert_gives_the_port_local_parts(what):
    p = 4
    if what == "matrix":
        a = laplace2d(12, 11)
        objs = (D.distribute(a, p), JD.distribute(jcsr(a), p))
    elif what == "stencil":
        objs = (D.distribute_stencil(laplace3d(6, 4, 12, fmt="stencil"), p),
                JD.distribute_stencil(jlaplace3d(6, 4, 12, fmt="stencil"), p))
    elif what == "amg":
        a = laplace3d(8, 6, 4)
        objs = (drv.dist_amg(a, tmap.Map.uniform(a.shape[0], p),
                             coarse_max=16),
                jdrv.dist_amg(jcsr(a), jmap.Map.uniform(a.shape[0], p),
                              coarse_max=16))
    else:
        objs = (drv.dist_cheb_fused(laplace3d(6, 4, 16, fmt="stencil"), p,
                                    lmax=1.9, device="cpu"),
                jdrv.dist_cheb_fused(jlaplace3d(6, 4, 16, fmt="stencil"), p,
                                     lmax=1.9))
    got, want = objs
    jnp_obj = jax.tree_util.tree_map(np.asarray, want)
    for s in range(p):
        conv = convert.dist_local_from_jax(jnp_obj, s, device="cpu")
        loc = got.local(s, "cpu")
        if what in ("amg", "cheb_fused"):
            assert conv.kind == loc.kind
            a_leaves, b_leaves = _leaves(conv.local), _leaves(loc.local)
            if what == "amg":
                a_leaves += _leaves(conv.replicated)
                b_leaves += _leaves(loc.replicated)
            assert len(a_leaves) == len(b_leaves)
            for g, w in zip(a_leaves, b_leaves):
                np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-14)
        else:
            assert conv.plan.mode == loc.plan.mode
            for g, w in zip(_leaves(conv), _leaves(loc), strict=True):
                np.testing.assert_array_equal(g, w)


def _leaves(tree):
    """Every tensor of a local part, as numpy, in field order."""
    import dataclasses

    import torch

    if isinstance(tree, torch.Tensor):
        return [tree.numpy()]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree)
                for x in _leaves(getattr(tree, f.name))]
    return []
