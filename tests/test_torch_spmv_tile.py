"""The single-vector stencil SpMV's launch plan and schedule, and the small
Cholesky kernel's lane schedule, checked on the CPU with numpy.

``spmv_plan`` must cover every grid point exactly once with aligned
vectors inside CUDA's limits; the plan's constants are the ``#define``s of
``csrc/spmv_plan.cuh``, and that header's launch check, built by the host
C compiler, accepts every plan ``spmv_plan`` makes and refuses plans that
do not fit. A numpy walk of ``stencil_kernel`` as the plan launches it
(threads, lanes, the x±1 values shuffled from the neighbouring lane or
loaded by the warp's edge lanes, clamped reads selected to +0, the
register queue of the z-march, the generic instance's term loop, pad
rows) gives ``stencil_spmv_plain`` bit for bit. A numpy model of
``chol_inv_kernel``'s lanes (row i in lane i, broadcasts by shuffle)
agrees with the plain version and with the JAX package's kernel to a
tolerance: its multiply-adds are contracted on the card and its rsqrt is
the hardware's, so it cannot be bitwise.
"""
import contextlib
import ctypes
import dataclasses
import pathlib
import re
import subprocess
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trilinos_tpu.ops import smalldense as jsd

from trilinos_tpu_torch.galeri.stencils import (cross2d_stencil,
                                                cross3d_stencil,
                                                star2d_stencil)
from trilinos_tpu_torch.ops import smalldense as tsd
from trilinos_tpu_torch.ops import stencil_op as so
from trilinos_tpu_torch.ops.stencil_op import (SpmvPlan, StencilOp,
                                               spmv_plan, stencil_spmv,
                                               stencil_spmv_plain)

CSRC = pathlib.Path(so.__file__).resolve().parent.parent / "csrc"
LAP3 = cross3d_stencil(6.0, -1.0, -1.0, -1.0, -1.0, -1.0, -1.0)
# the cross with unequal coefficients: each term's place is checked
CROSS = cross3d_stencil(5.5, -0.75, -1.25, -0.5, -1.5, -0.875, -1.125)
STAR2D = star2d_stencil(8.0, -1.0, -1.0, -1.0, -1.0, -0.5, -0.25, -0.125,
                        -0.0625)
GEOMETRIES = [(1, 1, 1), (2, 200, 1), (3, 5, 7), (16, 16, 16),
              (255, 256, 3), (257, 3, 2), (256, 256, 256), (1, 65535, 1),
              (1, 1, 65535), (37, 19, 11), (128, 128, 128)]
# (itemsize, pointer alignment in bytes)
ELEMENTS = [(4, 16), (4, 8), (4, 4), (8, 16), (8, 8)]


def dims_id(d):
    return "x".join(map(str, d))


def cdiv(a, b):
    return -(-a // b)


@pytest.fixture(scope="module")
def plan_check(tmp_path_factory):
    """``tt_spmv_plan_ok`` of csrc/spmv_plan.cuh, built by the host C
    compiler: check(plan, itemsize, x address, y address, dims, is the
    stencil the cross) -> bool."""
    out = tmp_path_factory.mktemp("spmv_plan")
    src = out / "check.c"
    src.write_text(
        '#include "spmv_plan.cuh"\n'
        "int check(const int* p, int itemsize, unsigned long long x,\n"
        "          unsigned long long y, int nx, int ny, int nz, int c) {\n"
        "  return tt_spmv_plan_ok(p, itemsize, (uintptr_t)x, (uintptr_t)y,\n"
        "                         nx, ny, nz, c);\n}\n")
    lib = out / "libcheck.so"
    subprocess.run(["cc", "-shared", "-fPIC", "-O1", "-Wall", "-Werror",
                    f"-I{CSRC}", "-o", str(lib), str(src)], check=True)
    fn = ctypes.CDLL(str(lib)).check
    fn.restype = ctypes.c_int

    def check(plan, itemsize, x, y, dims, cross):
        fields = plan.fields()
        return bool(fn(ctypes.c_void_p(fields.ctypes.data), itemsize,
                       ctypes.c_ulonglong(x), ctypes.c_ulonglong(y),
                       *dims, int(cross)))
    return check


def random_stencil(n_terms, seed, radius=2):
    """n_terms distinct offsets within radius, random coefficients."""
    rng = np.random.default_rng(seed)
    span = np.arange(-radius, radius + 1)
    offs = np.stack(np.meshgrid(span, span, span, indexing="ij"),
                    -1).reshape(-1, 3)
    pick = rng.choice(len(offs), n_terms, replace=False)
    return [(tuple(int(v) for v in offs[i]), float(rng.standard_normal()))
            for i in pick]


def covered_once(starts, width, n):
    idx = (np.asarray(starts)[:, None] + np.arange(width)[None, :]).ravel()
    idx = idx[idx < n]
    return np.array_equal(np.bincount(idx, minlength=n), np.ones(n, int))


@pytest.mark.parametrize("elem", ELEMENTS, ids=lambda e: "b%d-a%d" % e)
@pytest.mark.parametrize("dims", GEOMETRIES, ids=dims_id)
def test_spmv_plan_limits(dims, elem, plan_check):
    """Whole aligned vectors of the widest width nx and the pointers
    allow; blocks and z-chunks cover every point once, each block with
    work; CUDA's limits and the source's block size kept; the launcher's
    check accepts the plan."""
    itemsize, align = elem
    op = StencilOp.create(dims, LAP3)
    plan = spmv_plan(op, itemsize, align)
    nx, ny, nz = dims
    bx, by, bz = plan.block
    assert plan.cross and bz == 1
    assert 1 <= bx * by <= so.SPMV_THREADS and bx <= so.SPMV_ROW
    assert max(plan.grid[1:]) <= so.MAX_GRID_YZ
    assert 1 <= plan.zc <= so.SPMV_ZC
    assert nx % plan.vw == 0 and plan.vw * itemsize <= 16
    assert align % (plan.vw * itemsize) == 0
    wider = 2 * plan.vw
    assert wider * itemsize > 16 or nx % wider or align % (wider * itemsize)
    assert covered_once(np.arange(plan.grid[0]) * bx * plan.vw,
                        bx * plan.vw, nx)
    assert covered_once(np.arange(plan.grid[1]) * by, by, ny)
    assert covered_once(np.arange(plan.grid[2]) * plan.zc, plan.zc, nz)
    assert (plan.grid[2] - 1) * plan.zc < nz
    assert plan.grid == (cdiv(nx, bx * plan.vw), cdiv(ny, by),
                         cdiv(nz, plan.zc))
    assert plan_check(plan, itemsize, 1 << 20, (1 << 21) + align, dims, True)


@pytest.mark.parametrize("stencil", [
    STAR2D, cross2d_stencil(4.0, -1.0, -1.0, -1.0, -1.0),
    random_stencil(32, 0), random_stencil(17, 1), LAP3[::-1]],
    ids=["star2d", "cross2d", "32-terms", "17-terms", "cross-reordered"])
def test_generic_instance_plan(stencil, plan_check):
    """Any stencil but the cross in Galeri's order: one point a thread,
    one plane a block; the launcher's check accepts it."""
    for dims, block, grid in (((37, 19, 11), (37, 6, 1), (1, 4, 11)),
                              ((256, 9, 3), (64, 4, 1), (4, 3, 3)),
                              ((1, 300, 2), (1, 256, 1), (1, 2, 2))):
        op = StencilOp.create(dims, stencil)
        plan = spmv_plan(op, 4, 16)
        assert (plan.vw, plan.cross, plan.zc) == (1, False, 1)
        assert (plan.block, plan.grid) == (block, grid)
        assert plan_check(plan, 4, 1 << 20, 1 << 21, dims, False)


def grown(plan, axis):
    grid = list(plan.grid)
    grid[axis] += 1
    return dataclasses.replace(plan, grid=tuple(grid))


# (name, plan -> a plan the launcher must refuse, element size, x address
# offset, is the stencil the cross); every case starts from an accepted
# plan of a 64 × 8 × 20 cross in f32: vw 4, a block of 16 × 8 threads,
# z-chunk 4, grid (1, 1, 5)
BAD_PLANS = [
    ("grid x one too many", lambda p: grown(p, 0), 4, 0, True),
    ("grid y one too many", lambda p: grown(p, 1), 4, 0, True),
    ("grid z one too many", lambda p: grown(p, 2), 4, 0, True),
    ("grid z one too few", lambda p: dataclasses.replace(
        p, grid=p.grid[:2] + (p.grid[2] - 1,)), 4, 0, True),
    ("z-chunk without its grid", lambda p: dataclasses.replace(
        p, zc=2 * p.zc), 4, 0, True),
    ("z-chunk past TT_SPMV_ZC", lambda p: dataclasses.replace(
        p, zc=so.SPMV_ZC + 1, grid=p.grid[:2] + (1,)), 4, 0, True),
    ("cross instance for another stencil", lambda p: p, 4, 0, False),
    ("generic instance with a z-chunk", lambda p: dataclasses.replace(
        p, vw=1, cross=False, grid=(64, p.grid[1], p.grid[2])), 4, 0,
     True),
    ("16-byte vectors, x 8 bytes past alignment", lambda p: p, 4, 8, True),
    ("32-byte vectors", lambda p: dataclasses.replace(
        p, vw=8, block=(8, 8, 1)), 4, 0, True),
    ("vw 4 in f64", lambda p: p, 8, 0, True),
    ("block past TT_SPMV_THREADS", lambda p: dataclasses.replace(
        p, block=(16, 32, 1), grid=(1, 1, p.grid[2])), 4, 0, True),
    ("block past TT_SPMV_ROW", lambda p: dataclasses.replace(
        p, vw=1, block=(128, 2, 1), grid=(1, 4, p.grid[2])), 4, 0, True),
    ("block with depth", lambda p: dataclasses.replace(
        p, block=(16, 4, 2), grid=(1, 2, p.grid[2])), 4, 0, True),
]


@pytest.mark.parametrize("case", BAD_PLANS, ids=[c[0] for c in BAD_PLANS])
def test_launcher_check_refuses_bad_plans(case, plan_check):
    """Each plan differs from an accepted one in one way that would put a
    block past the last point, leave points out or break an alignment or
    a limit; the launcher's check refuses it."""
    _, bad, itemsize, shift, cross = case
    dims = (64, 8, 20)
    plan = dataclasses.replace(spmv_plan(StencilOp.create(dims, CROSS), 4,
                                         16), zc=4, grid=(1, 1, 5))
    assert (plan.vw, plan.block) == (4, (16, 8, 1))
    assert plan_check(plan, 4, 1 << 20, 1 << 21, dims, True)
    assert not plan_check(bad(plan), itemsize, (1 << 20) + shift, 1 << 21,
                          dims, cross)


def test_main_path_shape():
    """256³ f32: 16-byte vectors, 64 × 4 threads over a 256 × 4 tile, each
    block marching its z-chunk."""
    op = StencilOp.create((256, 256, 256), LAP3)
    plan = spmv_plan(op, 4)
    assert plan.vw == 4 and plan.block == (64, 4, 1)
    assert plan.grid == (1, 64, 256 // plan.zc)
    assert plan.grid[0] * plan.grid[1] * plan.grid[2] >= so.SPMV_MIN_BLOCKS


@pytest.mark.parametrize("name, value", [
    ("TT_SPMV_THREADS", so.SPMV_THREADS), ("TT_SPMV_ROW", so.SPMV_ROW),
    ("TT_SPMV_ZC", so.SPMV_ZC), ("TT_SPMV_GRID_YZ", so.MAX_GRID_YZ)],
    ids=["threads", "row", "zc", "grid-yz"])
def test_plan_constants_match_the_source(name, value):
    text = (CSRC / "spmv_plan.cuh").read_text()
    assert re.findall(rf"^#define {name} (\d+)", text, flags=re.M) == [
        str(value)]


def test_chol_constant_matches_the_source():
    text = (CSRC / "chol_inv_small.cu").read_text()
    assert re.findall(r"^#define TT_MAX_K (\d+)", text, flags=re.M) == [
        str(tsd.UNROLL_MAX)]


def spmv_walk(op, x, plan):
    """stencil_kernel in numpy, as ``plan`` launches it: every thread of
    the launch grid at once, one plane step at a time."""
    nx, ny, nz = op.dims
    n = op.n_rows
    dt = x.dtype.type
    zero = dt(0)
    c = np.asarray(op.coeffs, x.dtype)
    xg = x[:n].reshape(nz, ny, nx)
    y = np.full(op.n_rows_pad, np.nan, x.dtype)
    yg = y[:n].reshape(nz, ny, nx)
    bx, by, _ = plan.block
    gx, gy, gz = plan.grid
    vw = plan.vw
    # the launch's threads in xy: (row of threads, thread along x)
    ty_all, tx_all = np.meshgrid(np.arange(gy * by), np.arange(gx * bx),
                                 indexing="ij")
    tx, ty = tx_all % bx, ty_all % by
    lin = tx + bx * ty
    lane = lin % 32
    ix, iy = tx_all * vw, ty_all
    inside = (ix < nx) & (iy < ny)
    if not plan.cross:  # generic: one point a thread, the term loop
        xf = x[:n]
        for iz in range(gz):
            ixs, iys = ix[inside], iy[inside]
            gid = ixs + nx * (iys + ny * iz)
            acc = np.zeros(len(gid), x.dtype)
            for ck, (dx, dy, dz) in zip(c, op.offsets):
                ok = ((ixs + dx >= 0) & (ixs + dx < nx) & (iys + dy >= 0)
                      & (iys + dy < ny) & (0 <= iz + dz < nz))
                sel = gid[ok]
                acc[ok] = acc[ok] + ck * xf[sel + dx + nx * (dy + ny * dz)]
            y[gid] = acc
    else:  # the cross: vw points a thread, a register queue along z
        cx, cy = np.minimum(ix, nx - vw), np.minimum(iy, ny - 1)
        ok_ym, ok_yp = cy > 0, cy + 1 < ny
        ok_xm, ok_xp = cx > 0, cx + vw < nx
        own_xm = (lane == 0) | (tx == 0)
        own_xp = (lane == 31) | (tx + 1 == bx)
        # shuffle sources: linear index ∓ 1 in the same block (a lane
        # with no source reads its own value)
        blk_x, blk_y = tx_all - tx, ty_all - ty
        up = np.where(lane > 0, lin - 1, lin)
        dn = np.where((lane < 31) & (lin + 1 < bx * by), lin + 1, lin)
        src_up = (blk_y + up // bx, blk_x + up % bx)
        src_dn = (blk_y + dn // bx, blk_x + dn % bx)
        cols = cx[..., None] + np.arange(vw)

        def vec(z, rows):
            return xg[z][rows[..., None], cols]

        for bz in range(gz):
            z0, z1 = bz * plan.zc, min(bz * plan.zc + plan.zc, nz)
            prev = vec(max(z0 - 1, 0), cy)
            cur = vec(z0, cy)
            nxt = vec(min(z0 + 1, nz - 1), cy)
            for z in range(z0, z1):
                ahead = vec(min(z + 2, nz - 1), cy) if z + 1 < z1 else None
                ym = vec(z, cy - ok_ym)
                yp = vec(z, cy + ok_yp)
                xm_own = xg[z][cy, cx - ok_xm]
                xp_own = xg[z][cy, cx + np.where(ok_xp, vw, vw - 1)]
                xm = np.where(own_xm, xm_own, cur[src_up][..., vw - 1])
                xp = np.where(own_xp, xp_own, cur[src_dn][..., 0])
                for v in range(vw):
                    left = cur[..., v - 1] if v > 0 else xm
                    right = cur[..., v + 1] if v + 1 < vw else xp
                    acc = zero + c[0] * cur[..., v]
                    for ok, ck, val in (
                            ((v > 0) | ok_xm, c[1], left),
                            ((v + 1 < vw) | ok_xp, c[2], right),
                            (ok_ym, c[3], ym[..., v]),
                            (ok_yp, c[4], yp[..., v]),
                            (z > 0, c[5], prev[..., v]),
                            (z + 1 < nz, c[6], nxt[..., v])):
                        acc = acc + np.where(ok, ck * val, zero)
                    yg[z][iy[inside], ix[inside] + v] = acc[inside]
                prev, cur, nxt = cur, nxt, ahead
    y[n:] = x[n:]
    return y


def assert_bitwise(got, want):
    bits = np.int32 if got.dtype == np.float32 else np.int64
    assert np.array_equal(got.view(bits), want.view(bits))


def walk_against_plain(dims, stencil, dtype, align=16, n_pad=None, zc=None,
                       seed=0):
    op = StencilOp.create(dims, stencil, n_rows_pad=n_pad)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(op.n_rows_pad).astype(dtype)
    x[:dims[0] * dims[1]] = -0.0  # a plane of −0: sums of ±0 terms
    x[-1] = np.inf if n_pad else x[-1]  # a pad row is copied, never read
    plan = spmv_plan(op, np.dtype(dtype).itemsize, align)
    if zc is not None:
        plan = dataclasses.replace(plan, zc=zc, grid=plan.grid[:2] + (
            cdiv(dims[2], zc),))
    want = stencil_spmv_plain(op, torch.from_numpy(x)).numpy()
    assert_bitwise(spmv_walk(op, x, plan), want)
    return plan


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("dims", [(1, 1, 1), (2, 200, 1), (3, 5, 7),
                                  (16, 16, 16), (255, 64, 3), (257, 3, 2),
                                  (37, 19, 11), (64, 8, 20)], ids=dims_id)
def test_cross_walk_matches_plain(dims, dtype):
    walk_against_plain(dims, CROSS, dtype)


@pytest.mark.parametrize("case", [
    ((64, 8, 20), np.float32, 4), ((64, 8, 20), np.float32, 8),
    ((64, 8, 20), np.float64, 8), ((16, 16, 16), np.float32, 16)],
    ids=["f32-align4", "f32-align8", "f64-align8", "f32-16-cubed"])
def test_cross_walk_every_vector_width(case):
    """vw 1, 2 and 4 in f32, 1 and 2 in f64, and pad rows (5120 rows for
    16³, as the 16³ AMG-PCG path pads)."""
    dims, dtype, align = case
    n_pad = 5120 if dims == (16, 16, 16) else None
    plan = walk_against_plain(dims, CROSS, dtype, align=align, n_pad=n_pad)
    assert plan.vw == align // np.dtype(dtype).itemsize


@pytest.mark.parametrize("zc", [1, 2, 3, 4, 8, 16, 32])
def test_cross_walk_every_z_chunk(zc):
    """The swept variants: (a) one plane a block, (b) a z-march of zc
    planes, chunks that do not divide nz included."""
    walk_against_plain((32, 12, 21), CROSS, np.float32, zc=zc, seed=zc)


@pytest.mark.parametrize("block", [(10, 3), (7, 5), (33, 2), (25, 1)],
                         ids=lambda b: "%dx%d" % b)
def test_cross_walk_any_checked_block(block, plan_check):
    """Blocks the launcher accepts but the plan does not choose: rows cut
    across blocks at threads that are not lane 31 and warps cut short, so
    a block's last thread along x loads its x+1 value itself."""
    dims = (100, 6, 5)
    op = StencilOp.create(dims, CROSS)
    plan = spmv_plan(op, 4, 16)
    bx, by = block
    plan = SpmvPlan(vw=plan.vw, cross=True, block=(bx, by, 1), grid=(
        cdiv(dims[0], bx * plan.vw), cdiv(dims[1], by), 3), zc=2)
    assert plan_check(plan, 4, 1 << 20, 1 << 21, dims, True)
    x = np.random.default_rng(bx).standard_normal(op.n_rows_pad).astype(
        np.float32)
    want = stencil_spmv_plain(op, torch.from_numpy(x)).numpy()
    assert_bitwise(spmv_walk(op, x, plan), want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("stencil", [
    STAR2D, random_stencil(32, 2), random_stencil(9, 3),
    random_stencil(20, 4), LAP3[::-1]], ids=["star2d", "rand32", "rand9",
                                             "rand20", "cross-reordered"])
def test_generic_walk_matches_plain(stencil, dtype):
    dims = (31, 13, 1) if stencil is STAR2D else (17, 11, 9)
    walk_against_plain(dims, stencil, dtype, n_pad=4096, seed=5)


def no_plain(*args, **kwargs):
    raise AssertionError("the plain version ran for a device tensor")


def test_spmv_wrapper_launches_with_the_plan(monkeypatch):
    """With use_kernel true (as for a CUDA tensor) the wrapper hands the
    launcher its plan, counts the launch and never runs the plain
    version; past gridDim's limits it raises before any launch."""
    calls = []
    monkeypatch.setattr(so, "use_kernel", lambda t: True)
    monkeypatch.setattr(so, "stencil_spmv_plain", no_plain)
    monkeypatch.setattr(so, "_call", lambda fn, op, x, y, *extra, plan:
                        calls.append((fn, extra, plan)))
    monkeypatch.setattr(stencil_spmv, "launches", 0)
    op = StencilOp.create((64, 8, 20), CROSS)
    x = torch.zeros(op.n_rows_pad, dtype=torch.float64)
    stencil_spmv(op, x)
    assert calls == [("stencil_spmv_f64", (), spmv_plan(
        op, 8, so.pointer_align(x)))]
    assert stencil_spmv.launches == 1
    for dims in ((1, 65536, 1), (1, 1, 65536)):
        big = StencilOp.create(dims, LAP3)
        with pytest.raises(ValueError, match="65535"):
            stencil_spmv(big, torch.zeros(big.n_rows_pad))
    assert stencil_spmv.launches == 1 and len(calls) == 1


def chol_lanes(g):
    """chol_inv_kernel's schedule in numpy, to its compile-time bound K
    (the smallest of 8, 16, 32 that holds k; lanes, rows and columns past
    k hold zeros): lane i holds row i; step j takes row j's entries from
    lane j, forms column j of L (the pivot from lane j) and row j of L⁻¹
    (lane c: column c) from the same broadcasts. Returns (L, L⁻¹) as the
    kernel stores them, rows and columns below k."""
    k, dt = g.shape[0], g.dtype.type
    bound = next(b for b in (8, 16, 32) if k <= b)
    lane = np.arange(32)
    a = np.zeros((32, bound), g.dtype)  # a[i] = lane i's registers
    a[:k, :k] = g
    xc = np.zeros((32, bound), g.dtype)  # xc[c, m]: lane c's X[m][c]
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        for j in range(bound):
            dot = np.zeros(32, g.dtype)
            acc = np.zeros(32, g.dtype)
            for p in range(j):
                ljp = a[j, p]  # shuffle from lane j
                dot = dot + a[:, p] * ljp
                acc = acc + ljp * xc[:, p]
            s = a[:, j] - dot
            pivot = s[j]  # shuffle from lane j
            r = dt(1) / np.sqrt(pivot)
            a[:, j] = np.where(lane >= j, s * r, dt(0))
            xc[:, j] = ((lane == j).astype(g.dtype) - acc) * (
                dt(1) / (pivot * r))
    return a[:k, :k], xc[:k, :k].T


def spd(k, dtype, seed):
    """Gram matrix of a random (4k, k) panel: SPD, well conditioned."""
    a = np.random.default_rng(seed).standard_normal((4 * k, k))
    return (a.T @ a).astype(dtype)


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


# f32: the lanes sum in the plain version's order, the BLAS and the JAX
# kernel's lane reductions in others; 1e-5 is the port's f32 parity gate
# (tests/test_torch_smalldense.py). f64: the same sums, 1e-12.
@pytest.mark.parametrize("dtype, tol", [(np.float32, 1e-5),
                                        (np.float64, 1e-12)],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("k", [1, 2, 7, 16, 32])
def test_chol_lanes_match_plain_and_jax(k, dtype, tol):
    g = spd(k, dtype, seed=300 + k)
    l, linv = chol_lanes(g)
    assert l.dtype == dtype
    pl, plinv = tsd.chol_inv_small_plain(torch.from_numpy(g))
    if dtype == np.float32:  # the Pallas kernel, as its own tests run it
        jl, jlinv = jsd.chol_inv_small(jnp.asarray(g), interpret=True)
    else:  # the unrolled jnp pair (the Pallas kernel takes f32 only)
        jl, jlinv = jsd.chol_small(jnp.asarray(g)), None
        jlinv = jsd.tri_inv_small(jl, lower=True)
    for got, want in ((l, pl.numpy()), (linv, plinv.numpy()), (l, jl),
                      (linv, jlinv)):
        assert rel(got, want) <= tol
    np.testing.assert_array_equal(np.triu(l, 1), 0.0)
    np.testing.assert_array_equal(np.triu(linv, 1), 0.0)


def test_chol_lanes_nan_on_a_non_positive_pivot():
    """An indefinite g: the lanes, the plain version and the JAX unrolled
    pair all give NaN from the first non-positive pivot on, at the same
    places."""
    g = np.asarray([[4.0, 2.0, 1.0], [2.0, -1.0, 3.0], [1.0, 3.0, 2.0]])
    l, linv = chol_lanes(g)
    pl, plinv = tsd.chol_inv_small_plain(torch.from_numpy(g))
    jl = np.asarray(jsd.chol_small(jnp.asarray(g)))
    for got in (l, jl):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(pl.numpy()))
    np.testing.assert_array_equal(np.isnan(linv), np.isnan(plinv.numpy()))
    assert np.isnan(l[[1, 2, 2], [1, 1, 2]]).all()
    assert not np.isnan(l[:, 0]).any()


def test_chol_wrapper_launches_for_a_device_tensor(monkeypatch):
    """For a device tensor with k ≤ 32 the wrapper launches the kernel and
    counts it, never the plain version; a CPU tensor takes the plain
    version and counts nothing."""
    launched = []

    class Lib:
        def chol_inv_small_f32(self, g, l, linv, k, stream):
            launched.append(k)
            return 0

    monkeypatch.setattr(tsd, "use_kernel", lambda t: True)
    monkeypatch.setattr(tsd, "chol_inv_small_plain", no_plain)
    monkeypatch.setattr(tsd._build, "load", lambda name, sigs: Lib())
    monkeypatch.setattr(tsd.torch.cuda, "device", lambda d: contextlib.
                        nullcontext())
    monkeypatch.setattr(tsd.torch.cuda, "current_stream", lambda: types.
                        SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(tsd.chol_inv_small, "launches", 0)
    tsd.chol_inv_small(torch.eye(7))
    assert launched == [7] and tsd.chol_inv_small.launches == 1
    with pytest.raises(TypeError):
        tsd.chol_inv_small(torch.eye(7, dtype=torch.float16))
    assert tsd.chol_inv_small.launches == 1
