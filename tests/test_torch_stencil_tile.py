"""The host-side launch plans of the stencil SpMM, the DIA SpMM and the
fused CG iteration's z-marching tile, checked on the CPU with numpy index
arithmetic only.

For each geometry, column count, element size, pointer alignment and
stencil radius: the SpMMs' blocks and column lanes cover every grid point
(every row) and column exactly once with aligned vectors; the fused
iteration's tiles and z-chunks cover every grid point exactly once; each
launch keeps the card's limits (≤ 1024 threads a block, ≤ 1024 along
blockDim.x and .y and ≤ 64 along .z, ≤ 232,448 bytes of shared memory,
gridDim.y and gridDim.z ≤ 65535), grids of few, long rows included. A numpy walk of the fused iteration's
ring of plane tiles (the slot arithmetic of ``csrc/cg_fused.cu``) gives
the plain version's five vectors bit for bit. The wrappers hand a device
tensor to the launcher with its plan, never to the plain version, and
raise ValueError where no plan fits.
"""
import contextlib
import ctypes
import importlib
import pathlib
import re
import types

import numpy as np
import pytest
import torch

from trilinos_tpu_torch.ops import cg_fused as cgf
from trilinos_tpu_torch.ops import stencil_op as so
from trilinos_tpu_torch.ops.dia_spmv import dia_spmm_plan
from trilinos_tpu_torch.ops.formats import DiaMatrix
from trilinos_tpu_torch.ops.cg_fused import (cg_fused_applicable,
                                             cg_fused_iteration,
                                             cg_fused_iteration_plain,
                                             cg_fused_plan)
from trilinos_tpu_torch.ops.stencil_op import StencilOp, spmm_plan, stencil_spmm

# the package attribute of this name is the function, not the module
dia = importlib.import_module("trilinos_tpu_torch.ops.dia_spmv")
TX, TY, DEPTH = cgf.TILE_X, cgf.TILE_Y, cgf.DEPTH
CSRC = pathlib.Path(cgf.__file__).resolve().parent.parent / "csrc"

LAP3 = [((0, 0, 0), 6.0), ((-1, 0, 0), -1.0), ((1, 0, 0), -1.0),
        ((0, -1, 0), -1.0), ((0, 1, 0), -1.0), ((0, 0, -1), -1.0),
        ((0, 0, 1), -1.0)]
# radius 2 along every axis, asymmetric coefficients
WIDE = LAP3 + [((-2, 0, 0), 0.25), ((0, 2, 0), -0.125), ((0, 0, -2), 0.5),
               ((2, -1, 1), 0.0625)]
STENCILS = {1: LAP3, 2: WIDE}
# the last three: few, long rows, where a block of about 256 threads
# would pass 64 along blockDim.z
GEOMETRIES = [(1, 1, 1), (37, 19, 11), (256, 256, 256), (40, 30, 1),
              (64, 5, 20), (2, 200, 1), (3, 100, 1), (1, 500, 1)]
# (k, itemsize, pointer alignment in bytes)
COLUMNS = [(1, 4, 16), (3, 4, 16), (4, 4, 16), (16, 4, 16), (16, 4, 4),
           (16, 8, 16), (1024, 4, 16), (1023, 4, 16), (6, 8, 8)]


def dims_id(d):
    return "x".join(map(str, d))


def covered_once(starts, width, n):
    """Each of 0..n-1 lies in exactly one [s, s + width) ∩ [0, n)."""
    idx = (np.asarray(starts)[:, None] + np.arange(width)[None, :]).ravel()
    idx = idx[idx < n]
    return np.array_equal(np.bincount(idx, minlength=n), np.ones(n, int))


def check_limits(block, grid, smem=0):
    assert 1 <= np.prod(block) <= 1024
    assert 1 <= block[0] <= 1024 and 1 <= block[1] <= 1024
    assert 1 <= block[2] <= 64
    assert smem <= 232448
    assert grid[1] <= 65535 and grid[2] <= 65535


@pytest.mark.parametrize("radius", [1, 2])
@pytest.mark.parametrize("cols", COLUMNS, ids=lambda c: "k%d-b%d-a%d" % c)
@pytest.mark.parametrize("dims", GEOMETRIES, ids=dims_id)
def test_spmm_plan_covers_each_point_once(dims, cols, radius):
    k, itemsize, align = cols
    op = StencilOp.create(dims, STENCILS[radius])
    plan = spmm_plan(op, k, itemsize, align)
    lanes, rx, ry = plan.block
    check_limits(plan.block, plan.grid)
    nx, ny, nz = dims
    # whole vectors, aligned in the row and in memory, at most 16 bytes
    assert k % plan.vw == 0 and lanes * plan.vw == k
    assert align % (plan.vw * itemsize) == 0 and plan.vw * itemsize <= 16
    # the widest such vector
    wider = 2 * plan.vw
    assert (wider * itemsize > 16 or k % wider
            or align % (wider * itemsize))
    assert covered_once(np.arange(lanes) * plan.vw, plan.vw, k)
    assert covered_once(np.arange(plan.grid[0]) * rx, rx, nx)
    assert covered_once(np.arange(plan.grid[1]) * ry, ry, ny)
    assert plan.grid[2] == nz
    # every block has work
    assert (plan.grid[0] - 1) * rx < nx and (plan.grid[1] - 1) * ry < ny


@pytest.mark.parametrize("cols", COLUMNS, ids=lambda c: "k%d-b%d-a%d" % c)
@pytest.mark.parametrize("n_pad", [1, 1000, 128 ** 3, 70_000_001])
def test_dia_spmm_plan_covers_each_row_once(n_pad, cols):
    """The DIA SpMM: whole aligned vectors of the widest width, lanes that
    cover the k columns once, thread rows that cover the n_pad rows once,
    every block with work, CUDA's limits."""
    k, itemsize, align = cols
    plan = dia_spmm_plan(n_pad, k, itemsize, align)
    lanes, by, bz = plan.block
    check_limits(plan.block, plan.grid)
    assert plan.grid[1:] == (1, 1) and bz == 1
    assert k % plan.vw == 0 and lanes * plan.vw == k
    assert align % (plan.vw * itemsize) == 0 and plan.vw * itemsize <= 16
    wider = 2 * plan.vw
    assert (wider * itemsize > 16 or k % wider
            or align % (wider * itemsize))
    assert covered_once(np.arange(lanes) * plan.vw, plan.vw, k)
    assert (plan.grid[0] - 1) * by < n_pad <= plan.grid[0] * by
    if n_pad <= 10 ** 6:
        assert covered_once(np.arange(plan.grid[0]) * by, by, n_pad)


def test_dia_spmm_level_one_shape():
    """Level 1 of the 256³ hierarchy at k = 16: 16-byte vectors, 4 lanes a
    row, 64 rows a block."""
    plan = dia_spmm_plan(128 ** 3, 16, 4)
    assert plan.vw == 4 and plan.block == (4, 64, 1)
    assert plan.grid == (128 ** 3 // 64, 1, 1)


@pytest.mark.parametrize("radius", [1, 2])
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("dims", GEOMETRIES, ids=dims_id)
def test_cg_fused_plan_covers_each_point_once(dims, itemsize, radius):
    op = StencilOp.create(dims, STENCILS[radius], n_rows_pad=int(
        np.prod(dims)))
    assert cg_fused_applicable(op)
    plan = cg_fused_plan(op, itemsize)
    check_limits(plan.block, plan.grid, plan.smem)
    off = np.abs(np.asarray([o for o, _ in STENCILS[radius]]))
    assert (plan.rx, plan.ry, plan.rz) == tuple(off.max(axis=0))
    nx, ny, nz = dims
    assert plan.block == (TX, TY, 1)
    assert plan.threads % 32 == 0  # block_sum reduces whole warps
    halo = (TX + 2 * plan.rx) * (TY + 2 * plan.ry)
    assert plan.smem == (2 * plan.rz + 1 + DEPTH) * (
        3 * halo + 2 * plan.threads) * itemsize
    assert covered_once(np.arange(plan.grid[0]) * TX, TX, nx)
    assert covered_once(np.arange(plan.grid[1]) * TY, TY, ny)
    assert covered_once(np.arange(plan.grid[2]) * plan.zc, plan.zc, nz)
    assert (plan.grid[2] - 1) * plan.zc < nz


def test_main_path_shapes():
    """256³: the SpMM at k = 16 moves 16-byte vectors, 256 threads a
    block; the fused iteration's 32×8 tiles march 16 planes, 4096
    blocks."""
    op = StencilOp.create((256, 256, 256), LAP3)
    spmm = spmm_plan(op, 16, 4)
    assert spmm.vw == 4 and spmm.block == (4, 64, 1)
    assert spmm.grid == (4, 256, 256)
    cg = cg_fused_plan(op, 4)
    assert (TX, TY, cg.zc) == (32, 8, 16) and cg.n_blocks == 4096


@pytest.mark.parametrize("source, name, value", [
    ("cg_fused.cu", "TT_TILE_X", cgf.TILE_X),
    ("cg_fused.cu", "TT_TILE_Y", cgf.TILE_Y),
    ("cg_fused.cu", "TT_DEPTH", cgf.DEPTH),
    ("stencil_spmv.cu", "TT_MAX_COLS", so.MAX_COLS),
    ("tt_common.cuh", "TT_MAX_TERMS", so.MAX_TERMS),
    ("dia_spmv.cu", "TT_MAX_COLS", dia.MAX_COLS),
    ("dia_spmv.cu", "TT_MAX_DIAGS", dia.MAX_DIAGS),
], ids=["tile-x", "tile-y", "depth", "max-cols", "max-terms", "dia-max-cols",
        "dia-max-diags"])
def test_plan_constants_match_the_source(source, name, value):
    """The plans use the kernels' own constants: each ``#define`` in the
    CUDA source equals the Python constant the plan reads."""
    text = (CSRC / source).read_text()
    found = re.findall(rf"^#define {name} (\d+)", text, flags=re.M)
    assert found == [str(value)]


def ring_walk(op, state, plan):
    """The fused iteration's z-march in numpy, block by block: planes of r,
    w, q enter a ring of 2·rz + 1 + DEPTH halo tiles in the kernel's slot
    order, DEPTH planes ahead (plane zl + DEPTH lands in its slot
    before output plane zl − rz is read, so a slot still needed would be
    overwritten), +0 wherever a halo point or a plane lies outside the
    grid; x and p of output plane zo land in zo's slot. Each output point
    forms r' at every term's neighbour from the ring, with no mask."""
    nx, ny, nz = op.dims
    x, r, w, p, q, scal = (np.asarray(v) for v in state)
    dt = x.dtype.type
    rz, delta, rz_prev, alpha_prev = (dt(v) for v in scal[0])
    beta = rz / rz_prev if rz_prev > 0 else dt(0)
    denom = delta - beta * rz / (alpha_prev if alpha_prev != 0 else dt(1))
    alpha = rz / denom if denom != 0 else dt(0)
    grid3 = [v.reshape(nz, ny, nx) for v in (x, r, w, p, q)]  # by name
    outs = [np.full((nz, ny, nx), np.nan, x.dtype) for _ in range(5)]
    slots = 2 * plan.rz + 1 + DEPTH
    hxn, hyn = TX + 2 * plan.rx, TY + 2 * plan.ry
    coeffs = np.asarray(op.coeffs, x.dtype)
    for bx in range(plan.grid[0]):
        x0 = bx * TX
        gx = x0 - plan.rx + np.arange(hxn)
        okx = (gx >= 0) & (gx < nx)
        ix = x0 + np.arange(TX)
        ix = ix[ix < nx]
        for by in range(plan.grid[1]):
            y0 = by * TY
            gy = y0 - plan.ry + np.arange(hyn)
            oky = (gy >= 0) & (gy < ny)
            iy = y0 + np.arange(TY)
            iy = iy[iy < ny]
            for bz in range(plan.grid[2]):
                z0 = bz * plan.zc
                z1 = min(z0 + plan.zc, nz)
                z_end = z1 + plan.rz
                ring = np.full((3, slots, hyn, hxn), np.nan, x.dtype)
                own = np.full((2, slots, len(iy), len(ix)), np.nan, x.dtype)

                def issue(zn, slot):
                    ring[:, slot] = 0
                    if 0 <= zn < nz:
                        for a, v in enumerate((grid3[1], grid3[2], grid3[4])):
                            ring[a, slot][np.ix_(oky, okx)] = v[zn][np.ix_(
                                gy[oky], gx[okx])]
                    if z0 <= zn - plan.rz < z1:
                        at = (slot - plan.rz) % slots
                        for a, v in enumerate((grid3[0], grid3[3])):
                            own[a, at] = v[zn - plan.rz][np.ix_(iy, ix)]

                for d in range(DEPTH):
                    if z0 - plan.rz + d < z_end:
                        issue(z0 - plan.rz + d, d)
                slot = 0
                for zl in range(z0 - plan.rz, z_end):
                    if zl + DEPTH < z_end:
                        issue(zl + DEPTH, (slot + DEPTH) % slots)
                    zo = zl - plan.rz
                    if zo >= z0:
                        centre = (slot - plan.rz) % slots

                        def at(dx, dy, dz, a):
                            s = (centre + dz) % slots
                            return ring[a, s][np.ix_(
                                iy - y0 + plan.ry + dy,
                                ix - x0 + plan.rx + dx)]

                        acc = np.zeros((len(iy), len(ix)), x.dtype)
                        for (dx, dy, dz), c in zip(op.offsets, coeffs):
                            rj = at(dx, dy, dz, 0) - alpha * (
                                at(dx, dy, dz, 1) + beta * at(dx, dy, dz, 2))
                            acc = acc + c * rj
                        qn = at(0, 0, 0, 1) + beta * at(0, 0, 0, 2)
                        rn = at(0, 0, 0, 0) - alpha * qn
                        pn = at(0, 0, 0, 0) + beta * own[1, centre]
                        xn = own[0, centre] + alpha * pn
                        for o, v in zip(outs, (xn, rn, acc, pn, qn)):
                            o[zo][np.ix_(iy, ix)] = v
                    slot = (slot + 1) % slots
    return [o.ravel() for o in outs]


@pytest.mark.parametrize("case", [
    ((37, 19, 11), LAP3, np.float32, False),
    ((37, 19, 11), WIDE, np.float32, True),
    ((10, 12, 9), LAP3, np.float64, True),
    ((40, 30, 1), LAP3, np.float32, True),
], ids=["odd-first", "odd-radius2", "f64", "one-plane"])
def test_ring_walk_matches_plain(case):
    """The five vectors bit for bit, signs of zero included: a sum of
    round-to-nearest adds that starts at +0 never becomes −0, so the +0
    terms of the halo change nothing."""
    dims, stencil, dtype, later = case
    op = StencilOp.create(dims, stencil, n_rows_pad=int(np.prod(dims)))
    rng = np.random.default_rng(11)
    r, p, q = rng.standard_normal((3, op.n_rows)).astype(dtype)
    r[:3 * dims[0] * dims[1]] = -0.0  # planes of −0: sums of ±0 terms
    w = so.stencil_spmv_plain(op, torch.from_numpy(r)).numpy()
    scal = np.asarray([[r @ r, r @ w, 1.25 * (r @ r) if later else 0.0,
                        0.5 if later else 1.0]], dtype)
    if not later:
        p, q = p * 0, q * 0
    state = [p.copy(), r, w, p, q, scal]
    want = cg_fused_iteration_plain(op, *(torch.from_numpy(v)
                                          for v in state))
    got = ring_walk(op, state, cg_fused_plan(op, np.dtype(dtype).itemsize))
    bits = np.int32 if dtype == np.float32 else np.int64
    for g, v in zip(got, want[:5]):
        assert np.array_equal(g.view(bits), v.numpy().view(bits))


def no_plain(*args, **kwargs):
    raise AssertionError("the plain version ran for a device tensor")


def test_spmm_wrapper_launches_with_the_plan(monkeypatch):
    """With use_kernel true (as for a CUDA tensor) the wrapper hands the
    launcher its plan and never runs the plain version."""
    calls = []
    monkeypatch.setattr(so, "use_kernel", lambda t: True)
    monkeypatch.setattr(so, "stencil_spmv_plain", no_plain)
    monkeypatch.setattr(so, "_call", lambda fn, op, x, y, *extra, plan=None:
                        calls.append((fn, extra, plan)))
    monkeypatch.setattr(stencil_spmm, "launches", 0)
    op = StencilOp.create((37, 19, 11), WIDE)
    x = torch.zeros((op.n_rows_pad, 6), dtype=torch.float64)
    stencil_spmm(op, x)
    assert calls == [("stencil_spmm_f64", (6,),
                      spmm_plan(op, 6, 8, so.pointer_align(x)))]
    assert stencil_spmm.launches == 1


def test_dia_spmm_wrapper_launches_with_the_plan(monkeypatch):
    """The DIA SpMM wrapper hands the C launcher the plan's fields (bf16
    data and f32 X: the vectors are X's) and k, and counts the launch."""
    seen = []

    class Lib:
        def __getattr__(self, fn):
            def call(data, x, y, n_pad, k, nd, offs, plan, stream):
                fields = np.ctypeslib.as_array(
                    ctypes.cast(plan, ctypes.POINTER(ctypes.c_int32)),
                    shape=(7,)).copy()
                seen.append((fn, n_pad, k, nd, fields))
                return 0
            return call

    monkeypatch.setattr(dia, "use_kernel", lambda t: True)
    monkeypatch.setattr(dia, "dia_spmv_plain", no_plain)
    monkeypatch.setattr(dia._build, "load", lambda name, sigs: Lib())
    monkeypatch.setattr(dia.torch.cuda, "device", lambda d: contextlib.
                        nullcontext())
    monkeypatch.setattr(dia.torch.cuda, "current_stream", lambda: types.
                        SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(dia.dia_spmm, "launches", 0)
    a = DiaMatrix(data=torch.zeros((3, 2048), dtype=torch.bfloat16),
                  offsets=(-1, 0, 1), n_rows=2000, n_cols=2000, nnz=5998)
    x = torch.zeros((2048, 12))
    dia.dia_spmm(a, x)
    plan = dia_spmm_plan(2048, 12, 4, so.pointer_align(x))
    assert len(seen) == 1 and seen[0][:4] == ("dia_spmm_bf16f32", 2048, 12, 3)
    assert np.array_equal(seen[0][4], plan.fields())
    assert dia.dia_spmm.launches == 1


def test_cg_fused_wrapper_launches_with_the_plan(monkeypatch):
    calls = []
    monkeypatch.setattr(cgf, "use_kernel", lambda t: True)
    monkeypatch.setattr(cgf, "cg_fused_iteration_plain", no_plain)
    monkeypatch.setattr(cgf, "_call", lambda op, vecs, scal, outs, scal_out,
                        work, plan: calls.append((work.numel(), plan)))
    monkeypatch.setattr(cg_fused_iteration, "launches", 0)
    op = StencilOp.create((37, 19, 11), LAP3, n_rows_pad=37 * 19 * 11)
    vecs = [torch.zeros(op.n_rows) for _ in range(5)]
    cg_fused_iteration(op, *vecs, torch.zeros((1, 4)))
    plan = cg_fused_plan(op, 4)
    assert calls == [(2 * plan.n_blocks + 1, plan)]
    assert cg_fused_iteration.launches == 1


def test_beyond_the_limits_raise(monkeypatch):
    """No launch fits: a radius-20 ring, more than 65535 blocks along y,
    more than 1024 columns. The wrappers raise ValueError before any
    launch."""
    monkeypatch.setattr(so, "use_kernel", lambda t: True)
    monkeypatch.setattr(so, "stencil_spmv_plain", no_plain)
    monkeypatch.setattr(so, "_call", no_plain)
    monkeypatch.setattr(cgf, "use_kernel", lambda t: True)
    monkeypatch.setattr(cgf, "_call", no_plain)
    far = [((0, 0, 0), 1.0), ((20, 0, 0), 1.0), ((0, -20, 0), 1.0),
           ((0, 0, 20), 1.0)]
    wide = StencilOp.create((41, 41, 41), far, n_rows_pad=41 ** 3)
    with pytest.raises(ValueError):
        cg_fused_plan(wide, 4)
    assert not cg_fused_applicable(wide)
    with pytest.raises(ValueError):
        cg_fused_iteration(wide, *[torch.zeros(wide.n_rows)] * 5,
                           torch.zeros((1, 4)))
    tall = StencilOp.create((1, 600_000, 1), LAP3, n_rows_pad=600_000)
    with pytest.raises(ValueError):
        cg_fused_plan(tall, 4)  # 75,000 tiles along y
    assert not cg_fused_applicable(tall)
    taller = StencilOp.create((1, 17_000_000, 1), LAP3,
                              n_rows_pad=17_000_000)
    with pytest.raises(ValueError):
        spmm_plan(taller, 1, 4)  # 66,407 blocks of 256 rows along y
    deep = StencilOp.create((1, 1, 70_000), LAP3, n_rows_pad=70_000)
    with pytest.raises(ValueError):
        spmm_plan(deep, 16, 4)  # one plane per grid z
    small = StencilOp.create((8, 8, 8), LAP3)
    with pytest.raises(ValueError):
        spmm_plan(small, 1025, 4)
    with pytest.raises(ValueError):
        stencil_spmm(small, torch.zeros((small.n_rows_pad, 1025)))
