"""The fused stencil polynomial's launch plan, checked on the CPU with
numpy only.

``stencil_poly_plan`` cuts the stage chain into launches whose rings fit
a block's shared memory; each stage works on the block's tile grown by
the reach of the α ≠ 0 stages after it and runs rz planes behind the
previous α ≠ 0 stage. A numpy walk of the kernel's schedule (the slot
arithmetic and the per-plane masks of ``csrc/stencil_poly.cu``: x planes
enter a ring DEPTH planes ahead, +0 where a halo point or a plane lies
outside the grid; each stage writes its planes into a ring of its own;
neighbours on planes outside ``z_bounds`` are read from a zero plane, by
a flag per term and plane, as are the pad terms (coefficient 0) that
bring the term count to 7, 16 or 32, while a row's own u_{j−1}, u_{j−2}
and x are read as they are)
gives the plain versions bit for bit, signs of zero included, in one
launch and where the plan splits the chain. The wrapper hands a device
tensor to the launcher with its plan, never to the plain version.
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from trilinos_tpu_torch.ops import stencil_poly as tp
from trilinos_tpu_torch.ops.stencil_op import StencilOp
from trilinos_tpu_torch.solvers.sstep_gmres import newton_basis_stages

CSRC = pathlib.Path(tp.__file__).resolve().parent.parent / "csrc"

LAP3 = [((0, 0, 0), 6.0), ((-1, 0, 0), -1.0), ((1, 0, 0), -1.0),
        ((0, -1, 0), -1.0), ((0, 1, 0), -1.0), ((0, 0, -1), -1.0),
        ((0, 0, 1), -1.0)]
# radius 2 along every axis, asymmetric coefficients
WIDE = LAP3 + [((-2, 0, 0), 0.25), ((0, 2, 0), -0.125), ((0, 0, -2), 0.5),
               ((2, -1, 1), 0.0625)]
NEWTON4 = tuple((a, bt, g, 0.0) for a, bt, g in newton_basis_stages(
    [11.5, 6.0 + 2.5j, 6.0 - 2.5j, 0.8], 12.0))
NEWTON8 = tuple((a, bt, g, 0.0) for a, bt, g in newton_basis_stages(
    [11.5, 9.0 + 1.0j, 9.0 - 1.0j, 6.0, 4.0 + 2.0j, 4.0 - 2.0j, 1.5, 0.4],
    12.0))
STAGES = {
    "chebyshev3": tp.chebyshev_stages(1.9, 0.06, 3, 1 / 6.0),
    "chebyshev8": tp.chebyshev_stages(1.9, 0.06, 8, 1 / 6.0),
    "monomial1": tp.monomial_stages(1, 12.0),
    "monomial4": tp.monomial_stages(4, 12.0),
    "newton4": NEWTON4,
    "newton8": NEWTON8,
    "richardson3": tp.richardson_stages(0.8, 3, 1 / 6.0),
}


def plan_of(op, kind, itemsize):
    return tp.stencil_poly_plan(op, tuple(tuple(float(v) for v in st)
                                          for st in STAGES[kind]), itemsize)


def poly_walk(op, stages, x, z_bounds, plan, all_outputs):
    """The kernel's schedule in numpy, launch by launch and block by
    block. Slots never written hold NaN, so a read the plan did not
    provide for shows in the result."""
    nx, ny, nz = op.dims
    n, npad = op.n_rows, op.n_rows_pad
    z_lo, z_hi = z_bounds
    dt = x.dtype.type
    tx, ty = plan.tile
    rx, ry, rz = plan.radii
    cs = [dt(c) for c in op.coeffs]
    # the kernel pads the terms to 7, 16 or 32
    pad = next(t for t in (7, 16, 32) if len(cs) <= t) - len(cs)
    glob = {0: x}
    for j in tp.stored_stages(plan, stages, all_outputs):
        glob[j] = np.full(npad, np.nan, x.dtype)
        glob[j][n:] = x[n:]  # the launcher's copy of the pad rows
    for ln in plan.launches:
        j0, ns = ln.first, ln.count
        reach, slots = ln.reach, ln.slots
        W = [tx + 2 * h * rx for h in reach]
        H = [ty + 2 * h * ry for h in reach]
        g = [rz * h for h in reach]

        def view(j):  # a global vector as (nz, ny, nx)
            return glob[j][:n].reshape(nz, ny, nx)

        for bx in range(plan.grid[0]):
            for by in range(plan.grid[1]):
                gx = [bx * tx - h * rx + np.arange(w)
                      for h, w in zip(reach, W)]
                gy = [by * ty - h * ry + np.arange(hh)
                      for h, hh in zip(reach, H)]
                inside = [(gyy[:, None] >= 0) & (gyy[:, None] < ny)
                          & (gxx[None, :] >= 0) & (gxx[None, :] < nx)
                          for gxx, gyy in zip(gx, gy)]

                def gather(j, m, plane):
                    """Vector u_j at the points of region m on a plane
                    (outside the grid: NaN, never kept)."""
                    out = np.full((H[m], W[m]), np.nan, x.dtype)
                    ok = inside[m]
                    yy, xx = np.nonzero(ok)
                    out[ok] = view(j)[plane, gy[m][yy], gx[m][xx]]
                    return out

                for bz in range(plan.grid[2]):
                    z0 = bz * plan.zc
                    z1 = min(z0 + plan.zc, nz)
                    zs, ze = z0 - g[0], z1 + g[0]
                    rings = [np.full((slots[m], H[m], W[m]), np.nan,
                                     x.dtype) for m in range(ns)]

                    def load(zn):
                        tile = np.zeros((H[0], W[0]), x.dtype)
                        if 0 <= zn < nz:
                            tile[inside[0]] = gather(j0, 0, zn)[inside[0]]
                        rings[0][(zn - zs) % slots[0]] = tile

                    for d in range(tp.DEPTH):
                        if zs + d < ze:
                            load(zs + d)
                    for zl in range(zs, ze):
                        if zl + tp.DEPTH < ze:
                            load(zl + tp.DEPTH)
                        for m in range(1, ns + 1):
                            p = zl - rz * (reach[0] - reach[m])
                            if not max(0, z0 - g[m]) <= p < min(nz, z1 + g[m]):
                                continue
                            a, bt, gm, zt = (dt(v) for v in stages[j0 + m - 1])

                            def ring_at(r, plane, dx=0, dy=0):
                                """Ring r at region m's points + (dx, dy)."""
                                ix = (reach[r] - reach[m]) * rx + dx
                                iy = (reach[r] - reach[m]) * ry + dy
                                return rings[r][(plane - zs) % slots[r]][
                                    iy:iy + H[m], ix:ix + W[m]]

                            acc = np.zeros((H[m], W[m]), x.dtype)
                            zero = np.zeros_like(acc)
                            if a != 0:  # masked: the zero plane
                                for (dx, dy, dz), c in zip(op.offsets, cs):
                                    acc = acc + c * (
                                        ring_at(m - 1, p + dz, dx, dy)
                                        if z_lo <= p + dz < z_hi else zero)
                                for _ in range(pad):  # c = 0 on the zero plane
                                    acc = acc + dt(0) * zero
                                acc = a * acc
                            if bt != 0:
                                acc = acc + bt * ring_at(m - 1, p)
                            if gm != 0:
                                acc = acc + gm * (ring_at(m - 2, p) if m >= 2
                                                  else gather(j0 - 1, m, p))
                            if zt != 0:
                                acc = acc + zt * (ring_at(0, p) if j0 == 0
                                                  else gather(0, m, p))
                            acc = np.where(inside[m], acc, dt(0))
                            if m < ns:
                                rings[m][(p - zs) % slots[m]] = acc
                            j = j0 + m
                            if j in glob and z0 <= p < z1:
                                own = np.zeros_like(inside[m])
                                own[reach[m] * ry:reach[m] * ry + ty,
                                    reach[m] * rx:reach[m] * rx + tx] = True
                                own &= inside[m]
                                yy, xx = np.nonzero(own)
                                view(j)[p, gy[m][yy], gx[m][xx]] = acc[own]
    if all_outputs:
        return np.stack([glob[j] for j in range(1, len(stages) + 1)])
    return glob[len(stages)]


WALKS = [  # dims, stencil, n_pad, z_bounds, dtype, stages, small tiles
    ((70, 20, 11), LAP3, None, None, np.float32, "chebyshev3", False),
    ((70, 20, 11), LAP3, None, None, np.float32, "monomial4", False),
    ((13, 9, 10), LAP3, 2048, None, np.float32, "newton4", True),
    ((13, 9, 21), LAP3, None, (3, 18), np.float32, "chebyshev3", True),
    ((13, 9, 21), LAP3, None, (3, 18), np.float64, "newton8", True),
    ((11, 7, 12), WIDE, 1024, None, np.float32, "chebyshev8", True),
    ((11, 7, 12), WIDE, None, (2, 9), np.float64, "monomial4", True),
    ((9, 5, 6), WIDE, None, None, np.float64, "richardson3", False),
    ((1, 1, 1), LAP3, None, None, np.float32, "monomial1", False),
    ((5, 3, 2), LAP3, None, (1, 2), np.float64, "chebyshev3", False),
]


def walk_id(w):
    dims, st, npad, zb, dtype, kind, small = w
    return "-".join(["x".join(map(str, dims)), "r2" if st is WIDE else "r1",
                     "pad" if npad else "", f"zb{zb[0]}-{zb[1]}" if zb else "",
                     np.dtype(dtype).name, kind, "small" if small else ""])


@pytest.mark.parametrize("split", [False, True], ids=["fused", "split"])
@pytest.mark.parametrize("powers", [False, True], ids=["poly", "powers"])
@pytest.mark.parametrize("case", WALKS, ids=walk_id)
def test_walk_matches_plain_bitwise(monkeypatch, case, powers, split):
    """The walk gives the plain version's u_s or u_1..u_s bit for bit,
    with the plan's tile (or an 8×4 tile and 2-plane chunks, so several
    blocks meet in each direction) and in one launch or split where each
    launch takes at most two stages' rings."""
    dims, st, npad, zb, dtype, kind, small = case
    if small:
        monkeypatch.setattr(tp, "poly_tile", lambda *args: (8, 4))
        monkeypatch.setattr(tp, "MIN_ZC", 2)
        monkeypatch.setattr(tp, "TARGET_BLOCKS", 10 ** 6)
    op = StencilOp.create(dims, st, n_rows_pad=npad)
    itemsize = np.dtype(dtype).itemsize
    stages = tuple(tuple(float(v) for v in s_) for s_ in STAGES[kind])
    if split:
        tile = tp.poly_tile(itemsize, sum(s_[0] != 0.0 for s_ in stages),
                            tp.stencil_radii(op))
        one = max(tp._launch_geometry(stages[j:j + 1], j,
                                      tp.stencil_radii(op), tile,
                                      itemsize).smem
                  for j in range(len(stages)))
        monkeypatch.setattr(tp, "MAX_SMEM", 2 * one)
    tp.stencil_poly_plan.cache_clear()
    plan = tp.stencil_poly_plan(op, stages, itemsize)
    tp.stencil_poly_plan.cache_clear()
    if split and len(stages) > 2:
        assert len(plan.launches) > 1
    x = np.random.default_rng(5).standard_normal(op.n_rows_pad).astype(dtype)
    x[:op.dims[0] * op.dims[1]] = -0.0  # a plane of −0
    x[op.n_rows - 3:op.n_rows] = -0.0
    zb_ = zb or (0, dims[2])
    want = (tp.stencil_powers_plain if powers else tp.stencil_poly_plain)(
        op, stages, torch.from_numpy(x), z_bounds=zb_).numpy()
    got = poly_walk(op, stages, x, zb_, plan, powers)
    bits = np.int32 if dtype == np.float32 else np.int64
    assert got.shape == want.shape
    assert np.array_equal(got.view(bits), want.view(bits))


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("kind", STAGES)
@pytest.mark.parametrize("radius", [1, 2])
def test_plan_geometry(kind, radius, itemsize):
    """Per launch: the reach counts the α ≠ 0 stages after each ring; each
    ring holds the planes its readers span (2·rz + 1 for a ring read by
    an α stage, the x ring also DEPTH planes in flight); the shared bytes
    are the rings' and fit 232,448; the launches cover the stages in
    order, cut only where one more stage would not fit; the grid covers
    the points with CUDA's limits."""
    st = LAP3 if radius == 1 else WIDE
    dims = (200, 70, 33)
    op = StencilOp.create(dims, st)
    plan = plan_of(op, kind, itemsize)
    stages = tuple(tuple(float(v) for v in s_) for s_ in STAGES[kind])
    rx, ry, rz = plan.radii
    assert plan.radii == (radius, radius, radius)
    tx, ty = plan.tile
    # the item size's region less the whole chain's halo, whole warps wide
    reach = sum(s_[0] != 0.0 for s_ in stages)
    wx, wy = tp.REGION[itemsize]
    assert tx >= 16 and (tx + 2 * reach * rx - wx) % 32 == 0
    assert ty >= 8 and (ty + 2 * reach * ry - wy) % 8 == 0
    assert tx - 32 < 16 or tx + 2 * reach * rx == wx
    assert ty - 8 < 8 or ty + 2 * reach * ry == wy
    first = 0
    for i, ln in enumerate(plan.launches):
        assert ln.first == first and ln.count >= 1
        mine = stages[first:first + ln.count]
        alpha = [s_[0] != 0.0 for s_ in mine]
        assert ln.reach == tuple(sum(alpha[m:]) for m in range(ln.count + 1))
        for m in range(ln.count):
            need = 2 * rz if alpha[m] else 0
            if m + 1 < ln.count and mine[m + 1][2] != 0.0:
                need = max(need, rz * (alpha[m] + alpha[m + 1]))
            if m == 0 and first == 0:
                lags = [rz * sum(alpha[:j + 1]) for j in range(ln.count)
                        if mine[j][3] != 0.0]
                need = max([need] + lags)
            assert ln.slots[m] == need + 1 + (tp.DEPTH if m == 0 else 0)
        # the rings and one zero plane of the input ring's extent, every
        # plane with rows of the input region's width
        w0 = tx + 2 * ln.reach[0] * rx
        rows = [ty + 2 * h * ry for h in ln.reach]
        assert ln.smem == itemsize * w0 * (sum(
            sl * r for sl, r in zip(ln.slots, rows)) + rows[0])
        assert ln.smem <= 232448
        if i + 1 < len(plan.launches):  # one more stage would not fit
            assert tp._launch_geometry(
                stages[first:first + ln.count + 1], first, plan.radii,
                plan.tile, itemsize).smem > tp.MAX_SMEM
        first += ln.count
    assert first == len(stages)
    assert tp.THREADS <= 1024 and plan.grid[1] <= 65535 \
        and plan.grid[2] <= 65535
    assert (plan.grid[0] - 1) * tx < dims[0] <= plan.grid[0] * tx
    assert (plan.grid[1] - 1) * ty < dims[1] <= plan.grid[1] * ty
    assert (plan.grid[2] - 1) * plan.zc < dims[2] <= plan.grid[2] * plan.zc
    assert 1.0 <= plan.redundancy < 4.0


def test_main_path_plans():
    """256³ f32: the Chebyshev smoother (s = 3, stage 1 without α) and the
    s-step basis (s = 4) each run as one launch whose input region is
    64×32 (tiles 60×28 and 56×24, z-chunks of 25 and 28 planes); the
    redundant halo work in xy is 1.11× and 1.19×. The stencil is Galeri's
    7-point cross (``cross3d_stencil``), the term order the kernel's fast
    instance takes."""
    op = StencilOp.create((256, 256, 256), LAP3)
    cheb = plan_of(op, "chebyshev3", 4)
    mono = plan_of(op, "monomial4", 4)
    assert len(cheb.launches) == 1 and cheb.tile == (60, 28)
    assert len(mono.launches) == 1 and mono.tile == (56, 24)
    # rows of 64 columns: the kernel's instance for the 7-point cross
    assert cheb.tile[0] + 2 * 2 == 64 and mono.tile[0] + 2 * 4 == 64
    assert cheb.grid == (5, 10, 11) and cheb.zc == 25
    assert mono.grid == (5, 11, 10) and mono.zc == 28
    assert cheb.launches[0].reach == (2, 2, 1, 0)
    assert cheb.launches[0].slots == (3 + tp.DEPTH, 3, 3)
    assert mono.launches[0].reach == (4, 3, 2, 1, 0)
    assert round(cheb.redundancy, 3) == 1.109
    assert round(mono.redundancy, 3) == 1.189


@pytest.mark.parametrize("name, value", [
    ("TT_MAX_STAGES", tp.MAX_STAGES), ("TT_POLY_THREADS", tp.THREADS),
    ("TT_POLY_DEPTH", tp.DEPTH)], ids=["stages", "threads", "depth"])
def test_plan_constants_match_the_source(name, value):
    text = (CSRC / "stencil_poly.cu").read_text()
    assert re.findall(rf"^#define {name} (\d+)", text, flags=re.M) == \
        [str(value)]


def no_plain(*args, **kwargs):
    raise AssertionError("the plain version ran for a device tensor")


@pytest.mark.parametrize("powers", [False, True])
def test_wrapper_launches_with_the_plan(monkeypatch, powers):
    """With use_kernel true (as for a CUDA tensor) the wrapper hands the
    launcher the plan, counts one apply and the plan's launches, and never
    runs the plain version."""
    calls = []
    monkeypatch.setattr(tp, "use_kernel", lambda t: True)
    monkeypatch.setattr(tp, "stencil_poly_plain", no_plain)
    monkeypatch.setattr(tp, "stencil_powers_plain", no_plain)
    monkeypatch.setattr(tp, "_launch", lambda op, st, x, zb, all_outputs,
                        plan: calls.append((st, zb, all_outputs, plan)))
    fn = tp.stencil_powers_apply if powers else tp.stencil_poly_apply
    monkeypatch.setattr(fn, "launches", 0)
    monkeypatch.setattr(fn, "kernel_launches", 0)
    op = StencilOp.create((37, 19, 11), WIDE)
    stages = tp.power_stages(8)
    fn(op, stages, torch.zeros(op.n_rows_pad, dtype=torch.float64), (2, 9))
    plan = tp.stencil_poly_plan(op, stages, 8)
    assert len(plan.launches) > 1  # radius 2, s = 8, f64: split
    assert calls == [(stages, (2, 9), powers, plan)]
    assert fn.launches == 1 and fn.kernel_launches == len(plan.launches)
    with pytest.raises(TypeError):
        fn(op, stages, torch.zeros(op.n_rows_pad, dtype=torch.bfloat16))
    far = StencilOp.create((41, 41, 41), [((0, 0, 0), 1.0), ((20, 0, 0), 1.0),
                                          ((0, 20, 0), 1.0), ((0, 0, 20), 1.0)])
    with pytest.raises(ValueError, match="shared memory"):
        fn(far, stages, torch.zeros(far.n_rows_pad))
    assert len(calls) == 1
