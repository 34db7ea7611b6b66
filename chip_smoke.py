"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``trilinos_tpu_torch/csrc/``
and the native host SpGEMM, holds each kernel against its plain PyTorch
version on the card at every shape the paths give it, and drives ten
paths, each once through the kernels and once through the plain versions.
Seven run on the 256³ Laplace3D stencil:

* structured-AMG-preconditioned CG (``entry``) and AMG-preconditioned
  block GMRES, nrhs = 16, CGS2 + CholQR2 (``block_entry``), on one
  hierarchy with the damped-Jacobi smoother;
* AMG-PCG with the Chebyshev smoother (``cheb_entry``) on a second
  hierarchy;
* s-step GMRES with the matrix-powers basis (``sstep_entry``);
* fused-iteration CG (``fused_cg_entry``);
* GMRES(30) with CGS2 at a fixed 120 iterations (``gmres_entry``, the JAX
  bench's ``bench_gmres`` at this grid), with an f32 and then a bf16
  basis, and AMG-preconditioned GMRES(30) on the CG path's hierarchy.

Two run on Galeri 3-D Q1 elasticity through the BDIA kernel:

* CG preconditioned by the block-structured null-space AMG
  (``elasticity_entry``) on 48³ nodes (331,776 dofs), every level a
  BdiaMatrix (b = 3, then b = 6);
* CG in plane layout (``bdia_cg_entry``) on 64×64×48 nodes, 400
  iterations.

BASELINE config 2 (``bsr_gmres_entry``: Laplace3D 64³ stored as BSR with
b = 4, Relaxation, pseudo-block GMRES(30) on 4 right-hand sides, f64) runs
no hand-written kernel; it is gated on every column's true residual, and
``fgmres``, ``gmres_single_reduce`` and ``gmres_pipeline`` run its column 0.

Every hierarchy set-up must be served by the native SpGEMM. Each path
is driven with the launch counts set to 0 just before it and read just
after. It times each warm solve, times each kernel (device time of
CUDA-graph replays, and the host path of calls from Python) beside its
bound, its plain version and one PyTorch library call where there is one
(both by graph replay), profiles one solve of each path (device time by
kernel), and ends with one JSON line naming the device. Any failure exits non-zero; without a CUDA
device it exits non-zero before doing anything.
"""
import collections
import contextlib
import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

DIMS = (256, 256, 256)  # Laplace3D, 16.7 M unknowns
GRID = "x".join(map(str, DIMS))
NRHS = 16  # the block path's right-hand sides (BASELINE config 5)
RTOL = 1e-5  # both solves' tolerance; the true residual's gate
HBM_BYTES_PER_MS = 3.35e12 / 1e3  # H100 SXM device memory, 3.35 TB/s
F32_FLOPS_PER_MS = 67e12 / 1e3  # H100 SXM float32 outside the tensor cores
TOL = {torch.float32: 1e-6, torch.float64: 1e-13}
# chol_inv_small: kernel and plain version sum in different orders (the
# plain version's matvecs go through cuBLAS) and take rsqrt differently, so
# they agree to the type's rounding amplified by the factor's conditioning,
# not to the bit. Gates, by dtype: kernel vs plain, and the kernel's own
# residuals ‖L·Lᵀ − g‖/‖g‖ (backward error of a Cholesky factor, a few
# eps) and max|L⁻¹·L − I| (grows with cond(L), ≤ 10 on these panels). The
# f64 gates sit about 1000× above f64 rounding and below f32's, so a kernel
# that computed in f32 for f64 input fails them (the f32-rounded control
# in section 5 shows it does).
CHOL_TOL = {torch.float32: {"vs_plain": 1e-4, "llt": 1e-5, "inv": 1e-4},
            torch.float64: {"vs_plain": 1e-12, "llt": 1e-13, "inv": 1e-12}}
# the kernel and plain block solves stop at rtol 1e-5 along slightly
# different rounding, so their x agree to about the tolerance, not better
BLOCK_X_TOL = 1e-4
# cg_fused sums its dots per block in double, the plain version with
# torch.sum in f32; the difference in α, β compounds over the iterations.
# On an H100 the chained vectors and scal read at most 1.24e-6 and the
# 100-iteration x 1.15e-6: the gates sit about 10× above.
CG_FUSED_TOL = 1e-5  # five chained iterations: vectors and scal
FUSED_CG_X_TOL = 1e-5  # the first 100 iterations of the fused-CG path
# s-step GMRES: chol_inv_small agrees with its plain version to a
# tolerance, so the CholQR2 bases of the two runs differ by rounding
SSTEP_TOL = 1e-4  # per-cycle residual norms and x
FUSED_CG_ITERS = 100
EL_DIMS = (48, 48, 48)  # elasticity AMG-PCG nodes: 331,776 dofs
PLANE_DIMS = (64, 64, 48)  # plane-layout CG nodes: 589,824 dofs
PLANE_ITERS = 400
BDIA2D_DIMS = (1024, 512)  # the JAX bench's bare BDIA apply, b = 2
BDIA_X_TOL = 1e-4  # kernel and plain elasticity AMG-PCG stop at rtol 1e-5
PLANE_X_TOL = 1e-5  # the first PLANE_CHECK_ITERS plane-CG iterations
PLANE_CHECK_ITERS = 20
GMRES_ITERS = 120  # fixed-work GMRES(30) at rtol 0: four cycles
GMRES_BF16_X_TOL = 1e-4  # kernel and plain runs with a bf16 basis
CONFIG2_DIMS = (64, 64, 64)  # BASELINE config 2 at its stated size
CONFIG2_RTOL = 1e-7  # its true-residual gate, every column
BATCH, SAMPLES = 10, 25


def log(*parts):
    print(*parts, flush=True)


def fail(msg):
    raise SystemExit(f"FAIL {msg}")


def rel_err(got, want):
    """(max |Δ| / max |want|, max |Δ|)."""
    err = float((got.double() - want.double()).abs().max())
    return err / float(want.double().abs().max()), err


def check(name, got, want, tol):
    rel, err = rel_err(got, want)
    log(f"check {name}: max|Δ|/max|y| = {rel:.3e} (tol {tol:.0e})")
    if not rel <= tol:
        fail(f"{name}: {rel:.3e} > {tol:.0e}")
    return err


def time_ms(fn):
    """Per-call median over SAMPLES CUDA-event pairs, each around BATCH
    back-to-back calls, after three warm-up calls: the host path. The
    events bracket the host's enqueue of every call as well as the
    device's work, so a call whose host side (Python, allocation, the
    ctypes launch) outlasts its kernel reads the host's time, not the
    card's."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(SAMPLES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(BATCH):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / BATCH)
    return statistics.median(times)


def graph_ms(fn):
    """Device time per call: BATCH calls captured in one CUDA graph (after
    three warm-up calls on a side stream), the per-call median over
    SAMPLES timed replays. A replay enqueues the captured launches without
    the host's work, so this reads the card, down to the gaps between
    graph nodes (an empty kernel's replay time, ``empty_launch``)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(BATCH):
            fn()
    graph.replay()
    times = []
    for _ in range(SAMPLES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / BATCH)
    del graph
    return statistics.median(times)


def randn(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda", dtype=dtype)


def stencil_conv(op, k=1):
    """The 3×3×3 convolution that computes the same stencil apply, over a
    batch of k single-channel grids (input (k, 1, nz, ny, nx))."""
    w = torch.zeros((1, 1, 3, 3, 3), device="cuda")
    for (dx, dy, dz), c in zip(op.offsets, op.coeffs):
        w[0, 0, dz + 1, dy + 1, dx + 1] = c
    nx, ny, nz = op.dims

    def run(xb):
        return torch.nn.functional.conv3d(xb.view(k, 1, nz, ny, nx), w,
                                          padding=1)

    return run


def dia_as_csr(a):
    """The same DIA matrix as a torch sparse CSR tensor (entries stored
    where the column is in range and the value is nonzero)."""
    n = a.n_rows_pad
    rows = torch.arange(n, device="cuda").repeat(len(a.offsets))
    offs = torch.tensor(a.offsets, device="cuda").repeat_interleave(n)
    cols = rows + offs
    vals = a.data.reshape(-1)
    keep = (cols >= 0) & (cols < n) & (vals != 0)
    coo = torch.sparse_coo_tensor(torch.stack([rows[keep], cols[keep]]),
                                  vals[keep], (n, n)).coalesce()
    return coo.to_sparse_csr()


def bdia_blocks(a):
    """(block rows, block cols, (b, b) blocks) of a BdiaMatrix: every block
    whose column is in range, ordered by block row and then column."""
    nbr = a.nbr_pad
    q = torch.arange(nbr, device="cuda")
    offs = torch.tensor(a.offsets, device="cuda")
    cols = q[:, None] + offs[None, :]  # (nbr, nd), offsets ascending
    keep = (cols >= 0) & (cols < nbr)
    blocks = a.data.permute(3, 0, 1, 2)  # (nbr, nd, b, b)
    return (q[:, None].expand_as(cols)[keep], cols[keep], blocks[keep])


def bdia_as_csr(a):
    """The same BDIA matrix as a torch sparse CSR tensor (nonzero entries of
    the in-range blocks)."""
    b = a.block_size
    brow, bcol, blocks = bdia_blocks(a)
    i = torch.arange(b, device="cuda")
    rows = (brow[:, None, None] * b + i[:, None]).expand_as(blocks)
    cols = (bcol[:, None, None] * b + i[None, :]).expand_as(blocks)
    keep = blocks != 0
    n = a.n_rows_pad
    coo = torch.sparse_coo_tensor(torch.stack([rows[keep], cols[keep]]),
                                  blocks[keep], (n, n)).coalesce()
    return coo.to_sparse_csr()


def bdia_as_bsr(a):
    """The same BDIA matrix as a torch sparse BSR tensor of (b, b) blocks."""
    brow, bcol, blocks = bdia_blocks(a)
    crow = torch.zeros(a.nbr_pad + 1, dtype=torch.int64, device="cuda")
    crow[1:] = torch.cumsum(torch.bincount(brow, minlength=a.nbr_pad), 0)
    return torch.sparse_bsr_tensor(crow, bcol, blocks.contiguous(),
                                   (a.n_rows_pad, a.n_rows_pad))


def bdia_bytes(a, k, x_itemsize=4):
    """Bytes a BDIA apply must move: the planes once, x and y once each."""
    nd, b = len(a.offsets), a.block_size
    return (nd * b * b * a.data.element_size()
            + 2 * b * k * x_itemsize) * a.nbr_pad


def with_floor(g):
    """g plus cholqr's diagonal floor max(10·eps·max|g|, tiny)."""
    fl = torch.clamp(10.0 * torch.finfo(g.dtype).eps * g.abs().max(),
                     min=torch.finfo(g.dtype).tiny)
    return g + fl * torch.eye(g.shape[0], device=g.device, dtype=g.dtype)


def counts(wrappers):
    return {name: fn.launches for name, fn in wrappers.items()}


def zero(wrappers):
    """Set every count to 0, the fused-launch counts of the polynomial
    wrappers too."""
    for fn in wrappers.values():
        fn.launches = 0
        if hasattr(fn, "kernel_launches"):
            fn.kernel_launches = 0


def run_marked(step, args, owner, attr, wrappers):
    """Run ``step(*args)`` with the counts set to 0, recording them at each
    call of ``owner.attr`` (once per iteration or block step: the
    preconditioner, the block projection, the fused iteration). Returns
    (result, wall ms, counts, most common count moves between two marks,
    all moves)."""
    marks = []
    inner = getattr(owner, attr)

    def marked(*a, **k):
        marks.append(tuple(counts(wrappers).values()))
        return inner(*a, **k)

    zero(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(owner, attr, marked):
        res = step(*args)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    gaps = collections.Counter(
        tuple(b - a for a, b in zip(m0, m1))
        for m0, m1 in zip(marks, marks[1:]))
    if not gaps:
        fail(f"a path made fewer than two calls of {attr}")
    per = dict(zip(wrappers, gaps.most_common(1)[0][0]))
    return res, ms, counts(wrappers), per, dict(gaps)


def profile(label, fn, focus=None):
    """Device time by kernel and busy share of one run of ``fn``; with
    ``focus``, also the summed device time and launches of the kernels
    whose names contain it."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_kernel = {e.key: (e.self_device_time_total / 1e3, e.count)
                 for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA}
    busy = sum(ms for ms, _ in by_kernel.values())
    log(f"profiled {label}: {busy:.2f} ms of device time in {wall:.2f} ms "
        f"wall (busy share {busy / wall:.3f}); by kernel:")
    for key, (ms, count) in sorted(by_kernel.items(),
                                   key=lambda kv: -kv[1][0])[:14]:
        log(f"  {ms:8.3f} ms {count:5d} launches  {key[:100]}")
    if focus:
        hits = [v for key, v in by_kernel.items() if focus in key]
        log(f"profiled {label}: {focus} {sum(ms for ms, _ in hits):.3f} ms "
            f"of device time in {sum(n for _, n in hits)} launches")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    if not (pathlib.Path(__file__).resolve().parent
            / "trilinos_tpu_torch").is_dir():
        print("chip_smoke: no trilinos_tpu_torch beside the script; run it "
              "from a checkout of the repository", file=sys.stderr)
        sys.exit(2)

    import importlib

    from trilinos_tpu_torch import native
    from trilinos_tpu_torch.entry import (bdia_cg_entry, block_entry,
                                          bsr_gmres_entry, cheb_entry,
                                          elasticity_entry, entry,
                                          fused_cg_entry, gmres_entry,
                                          sstep_entry)
    from trilinos_tpu_torch.galeri import (elasticity2d, elasticity3d,
                                           laplace3d, rigid_body_modes)
    from trilinos_tpu_torch.galeri.stencils import (cross3d_stencil,
                                                    star2d_stencil)
    from trilinos_tpu_torch.ops import (BdiaMatrix, StencilOp,
                                        bdia_planes_plain, bdia_spmm,
                                        bdia_spmv, bdia_spmv_plain,
                                        cg_fused_iteration,
                                        cg_fused_iteration_plain,
                                        chol_inv_small, chol_inv_small_plain,
                                        dia_spmm, dia_spmv, dia_spmv_plain,
                                        stencil_poly_apply,
                                        stencil_poly_plain,
                                        stencil_powers_apply,
                                        stencil_powers_plain, stencil_spmm,
                                        stencil_spmv, stencil_spmv_plain)
    from trilinos_tpu_torch.ops import (_build, csr_to_bdia, matvec,
                                        pack_planes, smalldense, spgemm,
                                        stencil_op)
    from trilinos_tpu_torch.ops.stencil_poly import (monomial_stages,
                                                     stencil_chebyshev_setup)
    from trilinos_tpu_torch.precond import BlockStructuredAmg, SaAmg
    from trilinos_tpu_torch.precond.structured import ClassifiedStencil
    from trilinos_tpu_torch.solvers.sstep_gmres import newton_basis_stages

    # the package attributes of these names are functions, not modules
    cg_mod = importlib.import_module("trilinos_tpu_torch.solvers.cg")
    sstep_mod = importlib.import_module(
        "trilinos_tpu_torch.solvers.sstep_gmres")
    cheb_mod = importlib.import_module("trilinos_tpu_torch.precond.chebyshev")
    bdia_mod = importlib.import_module("trilinos_tpu_torch.ops.bdia_spmv")
    dia_mod = importlib.import_module("trilinos_tpu_torch.ops.dia_spmv")

    cg_kernels = {"stencil_spmv": stencil_spmv, "dia_spmv": dia_spmv}
    block_kernels = {"stencil_spmm": stencil_spmm, "dia_spmm": dia_spmm,
                     "chol_inv_small": chol_inv_small}
    cheb_kernels = {"stencil_poly": stencil_poly_apply, **cg_kernels}
    sstep_kernels = {"stencil_powers": stencil_powers_apply,
                     "chol_inv_small": chol_inv_small,
                     "stencil_spmv": stencil_spmv}
    fused_kernels = {"cg_fused": cg_fused_iteration,
                     "stencil_spmv": stencil_spmv}
    el_kernels = {"bdia_spmv": bdia_spmv}
    plane_kernels = {"bdia_spmm": bdia_spmm}
    all_kernels = {**cg_kernels, **block_kernels, **cheb_kernels,
                   **sstep_kernels, **fused_kernels, **el_kernels,
                   **plane_kernels}

    def setup(label, fn):
        """fn() with the SpGEMM path counts set to 0 just before; fails
        unless the native SpGEMM served every product. Returns (result,
        seconds)."""
        spgemm.native_calls = spgemm.numpy_calls = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        log(f"setup {label}: {secs:.2f} s; SpGEMM products: native "
            f"{spgemm.native_calls}, numpy {spgemm.numpy_calls}")
        if spgemm.numpy_calls or not spgemm.native_calls:
            fail(f"setup {label}: the native SpGEMM did not serve it")
        return out, secs

    # -- 1. the card ---------------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # -- 2. build (one nvcc per source, all started together) ----------------
    t0 = time.perf_counter()
    built = _build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"({', '.join(f'{k} {v:.2f} s' for k, v in built.items())})")
    t0 = time.perf_counter()
    lib = native.build()
    log(f"native SpGEMM build (g++): {time.perf_counter() - t0:.2f} s -> "
        f"{lib}")
    if lib is None:
        fail("no g++: the native SpGEMM cannot be built")
    for name in _build.KERNELS:
        report = (_build.BUILD_DIR / f"{name}.log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "Compiling entry" in line or "registers" in line \
                        or "spill" in line:
                    log(f"  ptxas {name}: {line.strip()}")

    # -- 3. stencil kernels against their plain versions ---------------------
    # the single-vector SpMV, bitwise, at the paths' shapes and at every
    # geometry of tests/test_torch_spmv_tile.py, f32 and f64, with pad
    # rows (n_pad rounds n up to 1024); x 4 and 8 bytes past 16-byte
    # alignment (vw 1 and 2); the generic instance on a 2-D 9-point star,
    # a radius-2 stencil, 32 random terms and the cross in another order
    lap = cross3d_stencil(6.0, *([-1.0] * 6))
    wide = lap + [((-2, 0, 0), 0.25), ((0, 2, 0), -0.125), ((0, 0, -2), 0.5),
                  ((2, -1, 1), 0.0625)]
    rng = np.random.default_rng(7)
    span = [(dx, dy, dz) for dz in range(-2, 3) for dy in range(-2, 3)
            for dx in range(-2, 3)]
    rand32 = [(span[i], float(c)) for i, c in zip(
        rng.choice(len(span), 32, replace=False), rng.standard_normal(32))]
    err = dict.fromkeys(all_kernels, 0.0)
    f32, f64 = torch.float32, torch.float64
    spmv_cases = [  # label, dims, stencil, n_pad, dtype, x offset
        (f"{GRID} f32", DIMS, lap, None, f32, 0),
        (f"{GRID} f64", DIMS, lap, None, f64, 0),
        (f"{GRID} f32, x 4 bytes past 16-byte alignment", DIMS, lap, None,
         f32, 1),
        ("100^3 f32", (100, 100, 100), lap, None, f32, 0),
        ("16^3 f32 pad rows (n_pad 5120)", (16, 16, 16), lap, 4096 + 1024,
         f32, 0),
        ("128^3 f64", (128, 128, 128), lap, None, f64, 0),
        ("64x8x20 f32, x 8 bytes past 16-byte alignment", (64, 8, 20), lap,
         None, f32, 2),
        ("64x8x20 f64, x 8 bytes past 16-byte alignment", (64, 8, 20), lap,
         None, f64, 1)]
    spmv_cases += [(f"{'x'.join(map(str, d))} {str(dt)[6:]}", d, lap, None,
                    dt, 0)
                   for d in ((1, 1, 1), (2, 200, 1), (3, 5, 7), (16, 16, 16),
                             (255, 256, 3), (255, 64, 3), (257, 3, 2),
                             (37, 19, 11), (64, 8, 20), (128, 128, 128),
                             (1, 65535, 1), (1, 1, 65535))
                   for dt in (f32, f64)]
    spmv_cases += [(f"{label} {str(dt)[6:]} (generic instance)", d, st, None,
                    dt, 0)
                   for label, d, st in (
                       ("31x13 2-D 9-point star", (31, 13), star2d_stencil(
                           8.0, *([-1.0] * 8))),
                       ("37x19x11 radius 2", (37, 19, 11), wide),
                       ("17x11x9 32 random terms", (17, 11, 9), rand32),
                       ("37x19x11 cross in reverse order", (37, 19, 11),
                        lap[::-1]))
                   for dt in (f32, f64)]
    for i, (label, dims, st, npad, dt, shift) in enumerate(spmv_cases):
        op = StencilOp.create(dims, st, n_rows_pad=npad)
        buf = randn(op.n_rows_pad + shift, dt, seed=10 + i)
        x = buf[shift:]
        y = stencil_spmv(op, x)
        torch.cuda.synchronize()
        plan = stencil_op.spmv_plan(op, x.element_size(),
                                    stencil_op.pointer_align(x, y))
        err["stencil_spmv"] = max(err["stencil_spmv"], check(
            f"stencil {label} (vw {plan.vw}, "
            f"{'cross' if plan.cross else 'generic'} instance, z-chunk "
            f"{plan.zc})", y, stencil_spmv_plain(op, x), 0.0))
        del buf, x, y
    # the launcher refuses a plan whose grid starts blocks past the last
    # plane (csrc/spmv_plan.cuh, as the CPU test builds it)
    op = StencilOp.create((37, 19, 11), lap)
    x = randn(op.n_rows_pad, f32, seed=9)
    plan = stencil_op.spmv_plan(op, 4, stencil_op.pointer_align(x))
    oversize = dataclasses.replace(plan, grid=plan.grid[:2] + (
        plan.grid[2] + 1,))
    try:
        stencil_op._call("stencil_spmv_f32", op, x, torch.empty_like(x),
                         plan=oversize)
    except RuntimeError as exc:
        log(f"check stencil_spmv launcher refuses grid {oversize.grid} for "
            f"37x19x11 (z-chunk {plan.zc}): {exc}")
    else:
        fail(f"stencil_spmv launcher took grid {oversize.grid} for 37x19x11")
    # the stencil SpMM, bitwise, at the block path's shape and at the edges
    # of its launch plan: a grid whose nx, ny are multiples of no block's
    # points (nor of the fused iteration's tile, nor nz of its z-chunk),
    # k = 1, 3, 4, pad rows, f64, an X whose data pointer is not 16-byte
    # aligned (the narrow-load instance), a radius-2 operator
    odd = (37, 19, 11)
    mv_cases = [  # label, dims, stencil, k, dtype, X offset in its buffer
        (f"{GRID} k={NRHS}", DIMS, lap, NRHS, torch.float32, 0),
        (f"{GRID} k=4", DIMS, lap, 4, torch.float32, 0),
        ("128^3 f64 k=16", (128, 128, 128), lap, NRHS, torch.float64, 0),
        (f"128^3 k={NRHS}, X 4 bytes past 16-byte alignment",
         (128, 128, 128), lap, NRHS, torch.float32, 1),
        ("10x10x8 (800 rows in 1024 pad rows) k=16", (10, 10, 8), lap, NRHS,
         torch.float32, 0)]
    mv_cases += [(f"37x19x11 k={k}", odd, lap, k, torch.float32, 0)
                 for k in (1, 3, 4, NRHS)]
    mv_cases += [
        ("37x19x11 k=16, X 4 bytes past 16-byte alignment", odd, lap, NRHS,
         torch.float32, 1),
        ("37x19x11 radius 2 k=16", odd, wide, NRHS, torch.float32, 0),
        ("37x19x11 radius 2 k=3 f64", odd, wide, 3, torch.float64, 0),
        # few, long rows: a block of 256 threads would pass 64 along z
        ("2x200x1 k=4 (block capped at 64 along z)", (2, 200, 1), lap, 4,
         torch.float32, 0)]
    for i, (label, dims, st, k, dt, shift) in enumerate(mv_cases):
        op = StencilOp.create(dims, st)
        buf = randn(op.n_rows_pad * k + shift, dt, seed=40 + i)
        x = buf[shift:].view(op.n_rows_pad, k)
        y = stencil_spmm(op, x)
        torch.cuda.synchronize()
        err["stencil_spmm"] = max(err["stencil_spmm"], check(
            f"stencil SpMM {label} {str(dt)[6:]} (X pointer % 16 = "
            f"{x.data_ptr() % 16})", y, stencil_spmv_plain(op, x), 0.0))
        del buf, x, y

    # -- 4. one hierarchy for both paths; DIA kernels on every level ---------
    fine = laplace3d(*DIMS, dtype=np.float32, fmt="stencil")
    amg, jacobi_setup_s = setup(f"{GRID} hierarchy", lambda: SaAmg(
        fine, {"dtype": np.float32}, device="cuda").compute())
    step, (b, state) = entry(amg=amg)
    log("levels " + " -> ".join(type(lv["a"]).__name__ + str(
            getattr(lv["a"], "offsets", ()).__len__())
            for lv in state["levels"])
        + f" -> dense {tuple(state['coarse_inv'].shape)}")
    levels = [lv["a"] for lv in state["levels"][1:]]
    bf16 = [type(a)(data=a.data.to(torch.bfloat16), offsets=a.offsets,
                    n_rows=a.n_rows, n_cols=a.n_cols, nnz=a.nnz)
            for a in levels]
    # bf16 data, f32 x and sum: both versions multiply the same widened
    # values and add in the same order, so f32's tolerance holds; the SpMM
    # is bitwise its plain version (same diagonal order and rounding)
    for i, (a, ab) in enumerate(zip(levels, bf16), start=1):
        xl = randn(a.n_rows_pad, torch.float32, seed=19 + i)
        err["dia_spmv"] = max(err["dia_spmv"], check(
            f"dia level-{i} {a.n_rows_pad} rows x {len(a.offsets)} diags "
            "f32", dia_spmv(a, xl), dia_spmv_plain(a, xl),
            TOL[torch.float32]))
        xk = randn((a.n_rows_pad, NRHS), torch.float32, seed=50 + i)
        for label, m in (("f32", a), ("bf16 data", ab)):
            err["dia_spmm"] = max(err["dia_spmm"], check(
                f"dia SpMM level-{i} k={NRHS} {label}", dia_spmm(m, xk),
                dia_spmv_plain(m, xk), 0.0))
    # the DIA SpMM at the edges of its plan, bitwise: k = 1, 3, 6 (4-, 4-
    # and 8-byte vectors), 1024 (256 lanes a row), an X 4 bytes past 16-byte
    # alignment (one column a thread), f64 (2 × f64 and one f64)
    lv2, coarsest = levels[1], levels[-1]
    lv2_f64 = dataclasses.replace(lv2, data=lv2.data.double())
    dia_edges = [  # label, matrix, k, dtype, X offset in its buffer
        ("level-2 k=1", lv2, 1, torch.float32, 0),
        ("level-2 k=3", lv2, 3, torch.float32, 0),
        ("level-2 k=6", lv2, 6, torch.float32, 0),
        (f"level-{len(levels)} k=1024", coarsest, 1024, torch.float32, 0),
        (f"level-1 k={NRHS}, X 4 bytes past 16-byte alignment", levels[0],
         NRHS, torch.float32, 1),
        ("level-2 k=16 bf16 data, X 4 bytes past 16-byte alignment",
         bf16[1], NRHS, torch.float32, 1),
        (f"level-2 k={NRHS} f64", lv2_f64, NRHS, torch.float64, 0),
        ("level-2 k=6 f64, X 8 bytes past 16-byte alignment", lv2_f64, 6,
         torch.float64, 1)]
    for i, (label, m, k, dt, shift) in enumerate(dia_edges):
        buf = randn(m.n_rows_pad * k + shift, dt, seed=60 + i)
        xk = buf[shift:].view(m.n_rows_pad, k)
        err["dia_spmm"] = max(err["dia_spmm"], check(
            f"dia SpMM {label} (X pointer % 16 = {xk.data_ptr() % 16})",
            dia_spmm(m, xk), dia_spmv_plain(m, xk), 0.0))
        del buf, xk
    a1, a1_bf16 = levels[0], bf16[0]
    x1 = randn(a1.n_rows_pad, torch.float32, seed=20)
    check("dia level-1 bf16 data", dia_spmv(a1_bf16, x1),
          dia_spmv_plain(a1_bf16, x1), TOL[torch.float32])

    # -- 5. chol_inv_small for every k it takes, f32 and f64 -----------------
    def chol_readings(g, l, linv, lp, linvp):
        """(vs plain, ‖LLᵀ − g‖/‖g‖, max|L⁻¹L − I|), all in g's type."""
        vs = max(rel_err(l, lp)[0], rel_err(linv, linvp)[0])
        llt = float(torch.linalg.norm(l @ l.T - g) / torch.linalg.norm(g))
        inv = float((linv @ l - torch.eye(g.shape[0], device="cuda",
                                          dtype=g.dtype)).abs().max())
        return vs, llt, inv

    def within(readings, tol):
        return all(r <= tol[key] for r, key in zip(
            readings, ("vs_plain", "llt", "inv")))

    for dt in (torch.float32, torch.float64):
        tol = CHOL_TOL[dt]
        worst = (0.0, 0.0, 0.0)
        for k in range(1, smalldense.UNROLL_MAX + 1):
            p = randn((4096, k), dt, seed=200 + k)
            for label, panel in (("random", p), ("scaled", p * torch.logspace(
                    -0.5, 0.5, k, device="cuda", dtype=dt))):
                g = with_floor(panel.T @ panel)
                l, linv = chol_inv_small(g)
                lp, linvp = chol_inv_small_plain(g)
                torch.cuda.synchronize()
                err["chol_inv_small"] = max(err["chol_inv_small"],
                                            rel_err(l, lp)[1],
                                            rel_err(linv, linvp)[1])
                got = chol_readings(g, l, linv, lp, linvp)
                worst = tuple(map(max, worst, got))
                if not within(got, tol):
                    fail(f"chol_inv_small {dt} k={k} {label}: vs plain "
                         f"{got[0]:.2e}, LLt {got[1]:.2e}, inv {got[2]:.2e} "
                         f"(tol {tol})")
                if k in (1, 16, 32):
                    log(f"check chol_inv_small {str(dt)[6:]} k={k} {label}: "
                        f"vs plain {got[0]:.3e}, ‖LLᵀ−g‖/‖g‖ {got[1]:.3e}, "
                        f"max|L⁻¹L−I| {got[2]:.3e} (tol {tol})")
                if dt == torch.float64 and k in (16, 32) and label == "random":
                    # the control: the f32 kernel on g rounded to f32, read
                    # in f64 as the f64 kernel is; the f64 gates must
                    # refuse it
                    l32, linv32 = chol_inv_small(g.float())
                    ctl = chol_readings(g, l32.double(), linv32.double(), lp,
                                        linvp)
                    log(f"control chol_inv_small f32 kernel on f64 g, k={k}: "
                        f"vs plain {ctl[0]:.3e}, ‖LLᵀ−g‖/‖g‖ {ctl[1]:.3e}, "
                        f"max|L⁻¹L−I| {ctl[2]:.3e} (f64 tol {tol})")
                    if within(ctl, tol):
                        fail(f"chol_inv_small f64 gates {tol} pass an f32 "
                             f"computation at k={k}")
        log(f"check chol_inv_small k=1..32 {str(dt)[6:]} (random and scaled "
            f"panels): worst vs plain {worst[0]:.3e}, ‖LLᵀ−g‖/‖g‖ "
            f"{worst[1]:.3e}, max|L⁻¹L−I| {worst[2]:.3e}, all within {tol}")

    # -- 5b. stencil polynomial and fused CG iteration kernels ---------------
    # the Chebyshev AMG smoother's stages (degree 3, Gershgorin λmax, as
    # SaAmg builds them) and the s-step bases: monomial σ = 12 and Newton
    # with one conjugate pair; every case bitwise
    cheb3 = stencil_chebyshev_setup(fine, 3, lmax=ClassifiedStencil
                                    .from_constant(fine.offsets, fine.coeffs)
                                    .gershgorin())
    cheb8 = stencil_chebyshev_setup(fine, 8, lmax=ClassifiedStencil
                                    .from_constant(fine.offsets, fine.coeffs)
                                    .gershgorin())
    mono1, mono4 = monomial_stages(1, 12.0), monomial_stages(4, 12.0)
    mono8 = monomial_stages(8, 12.0)
    newton4 = tuple((a, bt, g, 0.0) for a, bt, g in newton_basis_stages(
        [11.5, 6.0 + 2.5j, 6.0 - 2.5j, 0.8], 12.0))
    newton8 = tuple((a, bt, g, 0.0) for a, bt, g in newton_basis_stages(
        [11.5, 9.0 + 1.0j, 9.0 - 1.0j, 6.0, 4.0 + 2.0j, 4.0 - 2.0j, 1.5,
         0.4], 12.0))
    poly_cases = [  # label, dims, n_pad, z bounds, dtype, stages, powers
        # (a label naming radius 2 takes the radius-2 stencil)
        (f"{GRID} f32 Chebyshev s=3", DIMS, None, None, torch.float32,
         cheb3, False),
        (f"{GRID} f32 monomial s=4", DIMS, None, None, torch.float32, mono4,
         True),
        (f"{GRID} f32 Newton s=4 (one conjugate pair)", DIMS, None, None,
         torch.float32, newton4, True),
        ("16^3 f32 pad rows (n_pad 5120) Chebyshev", (16, 16, 16), 5120,
         None, torch.float32, cheb3, False),
        ("16^3 f32 pad rows (n_pad 5120) monomial", (16, 16, 16), 5120, None,
         torch.float32, mono4, True),
        ("64^3 f32 z bounds (3, 60) Chebyshev", (64, 64, 64), None, (3, 60),
         torch.float32, cheb3, False),
        ("64^3 f32 z bounds (3, 60) Newton", (64, 64, 64), None, (3, 60),
         torch.float32, newton4, True),
        ("128^3 f64 Chebyshev", (128, 128, 128), None, None, torch.float64,
         cheb3, False),
        ("128^3 f64 monomial", (128, 128, 128), None, None, torch.float64,
         mono4, True),
        ("64^3 f32 monomial s=1", (64, 64, 64), None, None, torch.float32,
         mono1, True),
        ("64^3 f32 Chebyshev s=1", (64, 64, 64), None, None, torch.float32,
         cheb3[:1], False),
        ("64^3 f32 Chebyshev s=8", (64, 64, 64), None, None, torch.float32,
         cheb8, False),
        ("64^3 f32 z bounds (3, 60) Newton s=8", (64, 64, 64), None, (3, 60),
         torch.float32, newton8, True),
        ("37x19x11 radius 2 f32 Chebyshev s=3", odd, None, None,
         torch.float32, cheb3, False),
        ("37x19x11 radius 2 f32 pad rows (n_pad 8192) monomial", odd, 8192,
         None, torch.float32, mono4, True),
        ("10x6x5 f32 (smaller than one tile) Newton", (10, 6, 5), None, None,
         torch.float32, newton4, True),
        ("10x6x5 f64 (smaller than one tile) Chebyshev", (10, 6, 5), None,
         None, torch.float64, cheb3, False),
        ("37x19x11 radius 2 f64 monomial s=8 (split launches)", odd, None,
         (2, 9), torch.float64, mono8, True),
        ("37x19x11 radius 2 f64 Chebyshev s=8 (split launches)", odd, None,
         None, torch.float64, cheb8, False)]
    poly_mod = importlib.import_module("trilinos_tpu_torch.ops.stencil_poly")
    for i, (label, dims, npad, zb, dt, stages, powers) in enumerate(
            poly_cases):
        st = wide if "radius 2" in label else lap
        op = StencilOp.create(dims, st, n_rows_pad=npad)
        plan = poly_mod.stencil_poly_plan(op, tuple(stages),
                                          torch.finfo(dt).bits // 8)
        if ("split" in label) != (len(plan.launches) > 1):
            fail(f"stencil polynomial {label}: {len(plan.launches)} "
                 "launches planned")
        x = randn(op.n_rows_pad, dt, seed=300 + i)
        name, kern, plain = (
            ("stencil_powers", stencil_powers_apply, stencil_powers_plain)
            if powers else
            ("stencil_poly", stencil_poly_apply, stencil_poly_plain))
        y = kern(op, stages, x, z_bounds=zb)
        torch.cuda.synchronize()
        err[name] = max(err[name], check(
            f"{name} {label}", y, plain(op, stages, x, z_bounds=zb), 0.0))
        del x, y
    # the fused polynomial's geometry on the two paths: tile, z-chunk,
    # rings and the redundant halo work the overlapped tiles cost
    for label, stages in (("Chebyshev s=3", cheb3), ("monomial s=4", mono4)):
        plan = poly_mod.stencil_poly_plan(fine, tuple(stages), 4)
        log(f"stencil polynomial plan {GRID} f32 {label}: tile {plan.tile}, "
            f"z-chunk {plan.zc}, grid {plan.grid}, launches "
            f"{[(ln.count, ln.slots, ln.smem) for ln in plan.launches]}, "
            f"xy halo work per output point and stage {plan.redundancy:.3f}")
    # one fused CG iteration from the same state: the five vectors bitwise
    # and scal to the tolerance; then five chained iterations, each side on
    # its own outputs; then a sixth from the plain chain's state on both
    # sides, where β and α_prev are not 0, again bitwise. max_abs_err reads
    # every single-iteration check, scal's absolute error included (scal
    # is held to CG_FUSED_TOL relative), and not the chained ones
    b0 = randn(fine.n_rows_pad, torch.float32, seed=400)
    w0 = stencil_spmv_plain(fine, b0)
    zeros = torch.zeros_like(b0)
    scal0 = torch.stack([b0 @ b0, b0 @ w0, zeros[0], zeros[0] + 1]).reshape(
        1, 4)
    k_state = p_state = (zeros, b0, w0, zeros, zeros, scal0)
    names = ("x", "r", "w", "p", "q", "scal")
    for it in range(5):
        k_state = cg_fused_iteration(fine, *k_state)
        p_state = cg_fused_iteration_plain(fine, *p_state)
        torch.cuda.synchronize()
        step_label = "iteration 1" if it == 0 else f"chained iteration {it + 1}"
        for nm, got, want in zip(names, k_state, p_state):
            e = check(f"cg_fused {GRID} f32 {step_label} {nm}", got, want,
                      CG_FUSED_TOL if nm == "scal" or it else 0.0)
            if it == 0:
                err["cg_fused"] = max(err["cg_fused"], e)
    rz, _, rz_prev, alpha_prev = p_state[5][0].tolist()
    k_state = cg_fused_iteration(fine, *p_state)
    p_state = cg_fused_iteration_plain(fine, *p_state)
    torch.cuda.synchronize()
    for nm, got, want in zip(names, k_state, p_state):
        err["cg_fused"] = max(err["cg_fused"], check(
            f"cg_fused {GRID} f32 iteration 6 from the plain chain's state "
            f"(β {rz / rz_prev:.6g}, α_prev {alpha_prev:.6g}) {nm}", got,
            want, CG_FUSED_TOL if nm == "scal" else 0.0))
    del k_state, p_state, b0, w0, zeros
    # one iteration at the edges of its tile, from a first state (β = 0)
    # and from one with β, α_prev ≠ 0: the odd grid, 128³ f64, radius 2
    for label, dims, st, dt in (
            ("37x19x11 f32", odd, lap, torch.float32),
            ("128^3 f64", (128, 128, 128), lap, torch.float64),
            ("37x19x11 radius 2 f32", odd, wide, torch.float32)):
        op = StencilOp.create(dims, st, n_rows_pad=int(np.prod(dims)))
        r0, p0, q0 = randn((3, op.n_rows), dt, seed=410)
        w0 = stencil_spmv_plain(op, r0)
        first = torch.stack([r0 @ r0, r0 @ w0, r0[0] * 0, r0[0] * 0 + 1])
        later = torch.stack([r0 @ r0, r0 @ w0, r0 @ r0 * 1.25,
                             r0[0] * 0 + 0.5])
        for when, scal, p_, q_ in (("β = 0", first, p0 * 0, q0 * 0),
                                   ("β ≠ 0", later, p0, q0)):
            cg_in = (p0, r0, w0, p_, q_, scal.reshape(1, 4))
            got = cg_fused_iteration(op, *cg_in)
            want = cg_fused_iteration_plain(op, *cg_in)
            torch.cuda.synchronize()
            for nm, g, w_ in zip(names, got, want):
                err["cg_fused"] = max(err["cg_fused"], check(
                    f"cg_fused {label} one iteration, {when}, {nm}", g, w_,
                    CG_FUSED_TOL if nm == "scal" else 0.0))

    # -- 6. the CG path, then the plain versions as reference ----------------
    res, solve_ms, cg_launches, cg_per, cg_gaps = run_marked(
        step, (b, state), SaAmg, "apply_state", cg_kernels)
    iters = int(res.iters)
    log(f"CG path: converged {bool(res.converged)} iters {iters} "
        f"first solve {solve_ms:.1f} ms launches {cg_launches}; launches "
        f"between preconditioner calls {cg_gaps}")
    if not bool(res.converged):
        fail("CG path did not converge")
    for name, count in cg_launches.items():
        if count == 0:
            fail(f"CG path never launched {name}")
    b64 = b.double()
    true_rel = float(torch.linalg.vector_norm(
        b64 - stencil_spmv_plain(fine, res.x.double()))
        / torch.linalg.vector_norm(b64))
    log(f"true relative residual (plain operator, f64): {true_rel:.3e}")
    if not true_rel <= RTOL:
        fail(f"true residual {true_rel:.3e} > {RTOL}")

    plain_patches = (
        (matvec, "stencil_spmv", stencil_spmv_plain),
        (matvec, "dia_spmv", dia_spmv_plain),
        (smalldense, "chol_inv_small", chol_inv_small_plain),
        (cheb_mod, "stencil_poly_apply", stencil_poly_plain),
        (sstep_mod, "stencil_powers_apply", stencil_powers_plain),
        (cg_mod, "cg_fused_iteration", cg_fused_iteration_plain),
        (matvec, "bdia_spmv", bdia_spmv_plain),
        (bdia_mod, "bdia_spmm", lambda a, x, layout="interleaved": (
            bdia_planes_plain if layout == "planes" else bdia_spmv_plain)(
                a, x)))

    def plain_run(fn, *args):
        """fn(*args) with the plain versions patched in for every kernel;
        fails if a kernel launched. Returns (result, wall ms)."""
        before = counts(all_kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            for owner, attr, plain in plain_patches:
                stack.enter_context(mock.patch.object(owner, attr, plain))
            out = fn(*args)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if counts(all_kernels) != before:
            fail("a plain reference run launched a kernel")
        return out, ms

    ref, plain_solve_ms = plain_run(step, b, state)
    rel_x, _ = rel_err(res.x, ref.x)
    log(f"plain reference: converged {bool(ref.converged)} iters "
        f"{int(ref.iters)} solve {plain_solve_ms:.1f} ms; "
        f"max|Δx|/max|x| = {rel_x:.3e}")
    if abs(int(ref.iters) - iters) > 1:
        fail(f"iteration counts {iters} vs {int(ref.iters)}")
    if not rel_x <= TOL[torch.float32]:
        fail(f"kernel and plain solves differ: {rel_x:.3e} > "
             f"{TOL[torch.float32]:.0e}")
    del ref
    # the first solve pays one-time costs (library handles, lazy module
    # loading); the same solve again is the steady-state time
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(b, state)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3

    # -- 7. the block GMRES path, then the plain versions as reference -------
    t0 = time.perf_counter()
    bstep, (bb, bstate) = block_entry(nrhs=NRHS, amg=amg)
    torch.cuda.synchronize()
    log(f"block right-hand sides ({GRID} x {NRHS}): "
        f"{time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    # the DIA SpMM's launches by level (rows) in this solve, recorded at
    # its launcher
    dia_by_rows = collections.Counter()
    dia_launch = dia_mod._launch

    def dia_recorded(kind, a, x):
        if kind == "spmm":
            dia_by_rows[a.n_rows_pad] += 1
        return dia_launch(kind, a, x)

    with mock.patch.object(dia_mod, "_launch", dia_recorded):
        bres, bsolve_ms, b_launches, b_per, b_gaps = run_marked(
            bstep, (bb, bstate), SaAmg, "apply_state", block_kernels)
    bpeak = torch.cuda.max_memory_allocated() / 2**30
    steps = int(bres.iters)
    log(f"block path: converged {bres.converged.tolist()} block steps "
        f"{steps} first solve {bsolve_ms:.1f} ms launches {b_launches}; "
        f"launches between preconditioner calls {b_gaps}; peak memory "
        f"{bpeak:.2f} GiB")
    if not bool(bres.converged.all()):
        fail("block path did not converge in every column")
    for name, count in b_launches.items():
        if count == 0:
            fail(f"block path never launched {name}")
    bb64 = bb.double()
    col_rel = (torch.linalg.vector_norm(
        bb64 - stencil_spmv_plain(fine, bres.x.double()), dim=0)
        / torch.linalg.vector_norm(bb64, dim=0))
    log(f"block true relative residuals (plain operator, f64): worst "
        f"{float(col_rel.max()):.3e}, best {float(col_rel.min()):.3e}")
    if not bool((col_rel <= RTOL).all()):
        fail(f"block true residual {float(col_rel.max()):.3e} > {RTOL}")
    bx = bres.x
    del bres
    torch.cuda.reset_peak_memory_stats()
    bref, bplain_ms = plain_run(bstep, bb, bstate)
    bplain_peak = torch.cuda.max_memory_allocated() / 2**30
    brel_x, _ = rel_err(bx, bref.x)
    log(f"block plain reference: converged {bool(bref.converged.all())} "
        f"block steps {int(bref.iters)} solve {bplain_ms:.1f} ms; "
        f"max|Δx|/max|x| = {brel_x:.3e}; peak memory {bplain_peak:.2f} GiB")
    if abs(int(bref.iters) - steps) > 1:
        fail(f"block steps {steps} vs {int(bref.iters)}")
    if not brel_x <= BLOCK_X_TOL:
        fail(f"kernel and plain block solves differ: {brel_x:.3e} > "
             f"{BLOCK_X_TOL:.0e}")
    del bref, bx
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bstep(bb, bstate)
    torch.cuda.synchronize()
    bwarm_ms = (time.perf_counter() - t0) * 1e3

    def warm(fn, *args):
        """Wall ms of a second, warm run of fn(*args)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def true_residual(x, rhs):
        r64 = rhs.double()
        return float(torch.linalg.vector_norm(
            r64 - stencil_spmv_plain(fine, x.double()))
            / torch.linalg.vector_norm(r64))

    # -- 7b. AMG-PCG with the Chebyshev smoother: a second hierarchy -------
    camg, cheb_setup_s = setup(f"{GRID} Chebyshev hierarchy", lambda: SaAmg(
        fine, {"dtype": np.float32, "smoother: type": "chebyshev"},
        device="cuda").compute())
    cstep, (cb, cstate) = cheb_entry(amg=camg)
    cres, csolve_ms, c_launches, c_per, c_gaps = run_marked(
        cstep, (cb, cstate), SaAmg, "apply_state", cheb_kernels)
    c_fused = stencil_poly_apply.kernel_launches
    citers = int(cres.iters)
    c_true = true_residual(cres.x, cb)
    log(f"Chebyshev path: converged {bool(cres.converged)} iters {citers} "
        f"first solve {csolve_ms:.1f} ms launches {c_launches}; launches "
        f"between preconditioner calls {c_gaps}; stencil_poly kernel "
        f"launches {c_fused}; true relative residual (plain operator, f64) "
        f"{c_true:.3e}")
    if not bool(cres.converged) or not c_true <= RTOL:
        fail(f"Chebyshev path: converged {bool(cres.converged)}, true "
             f"residual {c_true:.3e}")
    # every polynomial apply is one fused launch
    if c_fused != c_launches["stencil_poly"]:
        fail(f"Chebyshev path: {c_fused} polynomial kernel launches for "
             f"{c_launches['stencil_poly']} applies")
    # the fine level's 4 Jacobi sweeps become 2 polynomial applies (pre and
    # post); the coarse DIA levels smooth as on the Jacobi path
    if c_per != {"stencil_poly": 2, "stencil_spmv": 5,
                 "dia_spmv": cg_per["dia_spmv"]}:
        fail(f"Chebyshev path launches per iteration {c_per}")
    cref, cplain_ms = plain_run(cstep, cb, cstate)
    crel_x, _ = rel_err(cres.x, cref.x)
    log(f"Chebyshev plain reference: converged {bool(cref.converged)} iters "
        f"{int(cref.iters)} solve {cplain_ms:.1f} ms; max|Δx|/max|x| = "
        f"{crel_x:.3e}")
    if abs(int(cref.iters) - citers) > 1 or not crel_x <= TOL[torch.float32]:
        fail(f"Chebyshev kernel and plain solves differ: iters {citers} vs "
             f"{int(cref.iters)}, x {crel_x:.3e}")
    del cref
    cwarm_ms = warm(cstep, cb, cstate)

    # -- 7c. s-step GMRES with the matrix-powers basis ---------------------
    sstep, (sb,) = sstep_entry(dims=DIMS, device="cuda")
    norms = []
    norm2 = sstep_mod.norm2

    def recorded(*a):
        out = norm2(*a)
        norms.append(float(out))
        return out

    with mock.patch.object(sstep_mod, "norm2", recorded):
        sres, ssolve_ms, s_launches, s_per, s_gaps = run_marked(
            sstep, (sb,), sstep_mod, "cgs2_project_window", sstep_kernels)
        s_fused = stencil_powers_apply.kernel_launches
        k_norms, norms[:] = list(norms), []
        sref, splain_ms = plain_run(sstep, sb)
    s_true = true_residual(sres.x, sb)
    srel_x, _ = rel_err(sres.x, sref.x)
    srel_n = max(abs(a - b) / b for a, b in zip(k_norms, norms))
    log(f"s-step path: iters {sres.iters} (s=4, m=32, 5 cycles) first solve "
        f"{ssolve_ms:.1f} ms launches {s_launches}; launches between block "
        f"projections {s_gaps}; stencil_powers kernel launches "
        f"{s_fused}; residual norms (‖b‖, then β "
        f"and the true ‖r‖ of each cycle) {k_norms}; true relative residual "
        f"(plain operator, f64) {s_true:.3e}")
    log(f"s-step plain reference: iters {sref.iters} solve {splain_ms:.1f} "
        f"ms; norms {norms}; max rel Δ of the norms {srel_n:.3e}, "
        f"max|Δx|/max|x| = {srel_x:.3e}")
    if sres.iters != 160 or sref.iters != 160 or len(k_norms) != len(norms):
        fail(f"s-step runs: iters {sres.iters} vs {sref.iters}")
    if not (srel_n <= SSTEP_TOL and srel_x <= SSTEP_TOL):
        fail(f"s-step kernel and plain runs differ: norms {srel_n:.3e}, x "
             f"{srel_x:.3e} (tol {SSTEP_TOL:.0e})")
    for name, count in s_launches.items():
        if count == 0:
            fail(f"s-step path never launched {name}")
    if s_fused != s_launches["stencil_powers"]:
        fail(f"s-step path: {s_fused} matrix-powers kernel launches for "
             f"{s_launches['stencil_powers']} applies")
    del sref
    swarm_ms = warm(sstep, sb)

    # -- 7d. fused-iteration CG ---------------------------------------------
    fstep, (fb,) = fused_cg_entry(dims=DIMS, device="cuda")
    fres, fsolve_ms, f_launches, f_per, f_gaps = run_marked(
        fstep, (fb,), cg_mod, "cg_fused_iteration", fused_kernels)
    f_true = true_residual(fres.x, fb)
    log(f"fused CG path: converged {bool(fres.converged)} iters {fres.iters} "
        f"first solve {fsolve_ms:.1f} ms launches {f_launches}; launches "
        f"between iterations {f_gaps}; true relative residual (plain "
        f"operator, f64) {f_true:.3e}")
    if not bool(fres.converged) or not f_true <= RTOL:
        fail(f"fused CG path: converged {bool(fres.converged)}, true "
             f"residual {f_true:.3e}")
    if f_launches["cg_fused"] < fres.iters:
        fail(f"fused CG: {f_launches['cg_fused']} launches for "
             f"{fres.iters} iterations")
    fwarm_ms = warm(fstep, fb)
    f100, _ = fused_cg_entry(dims=DIMS, device="cuda", rtol=0.0,
                             maxiter=FUSED_CG_ITERS)
    k100 = f100(fb)
    p100, f100_plain_ms = plain_run(f100, fb)
    frel_x, _ = rel_err(k100.x, p100.x)
    frel_r = abs(float(k100.resnorm) - float(p100.resnorm)) / float(
        p100.resnorm)
    log(f"fused CG, first {FUSED_CG_ITERS} iterations (rtol 0): kernel "
        f"resnorm {float(k100.resnorm):.6e}, plain {float(p100.resnorm):.6e} "
        f"(rel Δ {frel_r:.3e}); max|Δx|/max|x| = {frel_x:.3e}; plain run "
        f"{f100_plain_ms:.1f} ms")
    if k100.iters != FUSED_CG_ITERS or p100.iters != FUSED_CG_ITERS or not (
            frel_x <= FUSED_CG_X_TOL and frel_r <= FUSED_CG_X_TOL):
        fail(f"fused CG kernel and plain runs differ: x {frel_x:.3e}, "
             f"resnorm {frel_r:.3e} (tol {FUSED_CG_X_TOL:.0e})")
    del k100, p100

    # -- 7e. the BDIA kernel against its plain version; the elasticity paths -
    # the two sides sum each row in another order: f32 tolerance, not bitwise
    def check_bdia(label, a, x, planes=False):
        name = "bdia_spmm" if planes or x.ndim == 2 else "bdia_spmv"
        got = (bdia_spmm(a, x, layout="planes") if planes
               else bdia_spmv(a, x))
        want = (bdia_planes_plain if planes else bdia_spmv_plain)(a, x)
        torch.cuda.synchronize()
        err[name] = max(err[name], check(f"bdia {label}", got, want,
                                         TOL[x.dtype]))

    def bdia_x(a, k, seed, planes=False, dtype=torch.float32):
        """Seed normals with zero pad rows, interleaved or as planes."""
        x = randn((a.n_rows_pad, k) if k > 1 else a.n_rows_pad, dtype, seed)
        x[a.n_rows:] = 0
        return pack_planes(a, x) if planes else x

    def assemble(label, fn):
        t0 = time.perf_counter()
        out = fn()
        log(f"assemble {label}: {time.perf_counter() - t0:.2f} s, "
            f"{out.shape[0]} dofs, {out.nnz} nonzeros")
        return out

    def no_plain(*args, **kwargs):
        fail("a plain BDIA apply ran on a kernel path")

    def csr_f64(h):
        """The host CSR on the card in f64, for true residuals."""
        return torch.sparse_csr_tensor(
            torch.from_numpy(h.row_ptr), torch.from_numpy(
                h.cols.astype(np.int64)), torch.from_numpy(
                h.vals.astype(np.float64)), h.shape).to("cuda")

    def host_residual(csr, x, rhs):
        n = csr.shape[0]
        r64 = rhs[:n].double()
        return float(torch.linalg.vector_norm(r64 - csr @ x[:n].double())
                     / torch.linalg.vector_norm(r64))

    grid2 = "x".join(map(str, BDIA2D_DIMS))
    a2 = csr_to_bdia(assemble(f"elasticity2d {grid2}", lambda: elasticity2d(
        *BDIA2D_DIMS, e_mod=1.0, dtype=np.float32)), 2, dtype=np.float32,
        device="cuda")
    for k in (1, NRHS):
        check_bdia(f"elasticity2d {grid2} b=2 nd={len(a2.offsets)} planes "
                   f"k={k} f32", a2, bdia_x(a2, k, 500 + k, planes=True),
                   planes=True)
    grid_p = "x".join(map(str, PLANE_DIMS))
    e3 = assemble(f"elasticity3d {grid_p}", lambda: elasticity3d(
        *PLANE_DIMS, e_mod=1.0, dtype=np.float32))
    a3 = csr_to_bdia(e3, 3, dtype=np.float32, device="cuda")
    for k in (1, 4):
        for planes in (False, True):
            check_bdia(f"elasticity3d {grid_p} b=3 nd={len(a3.offsets)} "
                       f"{'planes' if planes else 'interleaved'} k={k} f32",
                       a3, bdia_x(a3, k, 510 + k, planes), planes)
    apad = csr_to_bdia(elasticity3d(10, 10, 9, e_mod=1.0, dtype=np.float32),
                       3, dtype=np.float32, device="cuda")
    if apad.nbr_pad != 904:
        fail(f"pad-row case has {apad.nbr_pad} block rows, not 904")
    for planes in (False, True):
        check_bdia(f"elasticity3d 10x10x9 (900 block rows in 904) "
                   f"{'planes' if planes else 'interleaved'} f32", apad,
                   bdia_x(apad, 1, 520, planes), planes)

    grid_e = "x".join(map(str, EL_DIMS))
    ea = assemble(f"elasticity3d {grid_e}", lambda: elasticity3d(
        *EL_DIMS, e_mod=1.0, dtype=np.float32))
    eamg, el_setup_s = setup(f"elasticity {grid_e} block AMG", lambda:
                             BlockStructuredAmg(
                                 ea, {"dtype": np.float32,
                                      "coarse: max size": 3000},
                                 node_dims=EL_DIMS,
                                 nullspace=rigid_body_modes(*EL_DIMS),
                                 n_equations=3, device="cuda").compute())
    estep, (eb, est) = elasticity_entry(amg=eamg)
    el_levels = [lv["a"] for lv in eamg.levels]
    log("elasticity levels " + " -> ".join(
        f"BDIA b={a.block_size} nd={len(a.offsets)} nbr={a.nbr_pad}"
        for a in el_levels) + f" -> dense {tuple(eamg.coarse_inv.shape)}")
    if sorted({a.block_size for a in el_levels}) != [3, 6]:
        fail("the elasticity hierarchy has no b = 3 and b = 6 levels")
    for i, a in enumerate(el_levels):
        check_bdia(f"elasticity {grid_e} level {i} b={a.block_size} "
                   f"nd={len(a.offsets)} nbr={a.nbr_pad} f32", a,
                   bdia_x(a, 1, 530 + i))
    a0 = el_levels[0]
    a0_bf16 = dataclasses.replace(a0, data=a0.data.to(torch.bfloat16))
    check_bdia(f"elasticity {grid_e} level 0 bf16 data, f32 x", a0_bf16,
               bdia_x(a0, 1, 540))
    a1_f64 = dataclasses.replace(el_levels[1],
                                 data=el_levels[1].data.double())
    check_bdia(f"elasticity {grid_e} level 1 f64", a1_f64,
               bdia_x(a1_f64, 1, 541, dtype=torch.float64))

    ecsr = csr_f64(ea)
    with mock.patch.object(bdia_mod, "bdia_spmv_plain", no_plain):
        eres, esolve_ms, e_launches, e_per, e_gaps = run_marked(
            estep, (eb, est), BlockStructuredAmg, "apply_state", el_kernels)
    eiters = int(eres.iters)
    e_true = host_residual(ecsr, eres.x, eb)
    log(f"elasticity AMG-PCG path: converged {bool(eres.converged)} iters "
        f"{eiters} first solve {esolve_ms:.1f} ms launches {e_launches}; "
        f"launches between preconditioner calls {e_gaps}; true relative "
        f"residual (host CSR, f64) {e_true:.3e}")
    if not bool(eres.converged) or not e_true <= RTOL:
        fail(f"elasticity path: converged {bool(eres.converged)}, true "
             f"residual {e_true:.3e}")
    if e_launches["bdia_spmv"] == 0:
        fail("elasticity path never launched bdia_spmv")
    eref, eplain_ms = plain_run(estep, eb, est)
    erel_x, _ = rel_err(eres.x, eref.x)
    log(f"elasticity plain reference: converged {bool(eref.converged)} iters "
        f"{int(eref.iters)} solve {eplain_ms:.1f} ms; max|Δx|/max|x| = "
        f"{erel_x:.3e}")
    if abs(int(eref.iters) - eiters) > 1 or not erel_x <= BDIA_X_TOL:
        fail(f"elasticity kernel and plain solves differ: iters {eiters} vs "
             f"{int(eref.iters)}, x {erel_x:.3e} (tol {BDIA_X_TOL:.0e})")
    del eref
    ewarm_ms = warm(estep, eb, est)

    # -- 7f. CG in plane layout on the 64x64x48 elasticity operator ----------
    pstep, (pb,) = bdia_cg_entry(a=a3, iters=PLANE_ITERS)
    zero(plane_kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(bdia_mod, "bdia_planes_plain", no_plain):
        pres = pstep(pb)
    torch.cuda.synchronize()
    psolve_ms = (time.perf_counter() - t0) * 1e3
    p_launches = counts(plane_kernels)
    p3csr = csr_f64(e3)
    p_true = host_residual(p3csr, pres.x, pb)
    log(f"plane-layout CG path: iters {pres.iters} (rtol 0) first solve "
        f"{psolve_ms:.1f} ms launches {p_launches}; recurrence residual "
        f"{float(pres.resnorm):.6e}; true relative residual (host CSR, f64) "
        f"{p_true:.3e}")
    if pres.iters != PLANE_ITERS or p_launches["bdia_spmm"] < PLANE_ITERS:
        fail(f"plane CG: {pres.iters} iterations, launches {p_launches}")
    if not p_true < 1e-2:
        fail(f"plane CG did not reduce the residual: {p_true:.3e}")
    pwarm_ms = warm(pstep, pb)
    pcheck, _ = bdia_cg_entry(a=a3, iters=PLANE_CHECK_ITERS)
    kchk = pcheck(pb)
    rchk, pchk_plain_ms = plain_run(pcheck, pb)
    prel_x, _ = rel_err(kchk.x, rchk.x)
    log(f"plane CG, first {PLANE_CHECK_ITERS} iterations: kernel and plain "
        f"max|Δx|/max|x| = {prel_x:.3e}; plain run {pchk_plain_ms:.1f} ms")
    if not prel_x <= PLANE_X_TOL:
        fail(f"plane CG kernel and plain runs differ: {prel_x:.3e} > "
             f"{PLANE_X_TOL:.0e}")
    del kchk, rchk

    # -- 7g. GMRES(30) with CGS2, fixed work (rtol 0): f32 and bf16 basis ----
    gmres_mod = importlib.import_module("trilinos_tpu_torch.solvers.gmres")
    gmres_kernels = {"stencil_spmv": stencil_spmv}
    gmres_runs = {}
    for label, bdt, xtol in (("f32 basis", None, TOL[torch.float32]),
                             ("bf16 basis", torch.bfloat16,
                              GMRES_BF16_X_TOL)):
        gstep, gargs = gmres_entry(dims=DIMS, device="cuda", rtol=0.0,
                                   maxiter=GMRES_ITERS, basis_dtype=bdt)
        # the solve's own peak: above what the earlier paths keep allocated
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        gres, gsolve_ms, g_launches, g_per, g_gaps = run_marked(
            gstep, gargs, gmres_mod, "cgs2_project_rows", gmres_kernels)
        gpeak = (torch.cuda.max_memory_allocated() - held) / 2**30
        # one residual before the first cycle and one after each cycle
        want = gres.iters + -(-gres.iters // 30) + 1
        g_true = true_residual(gres.x, gargs[0])
        log(f"GMRES(30) {GRID} f32, {label}, rtol 0: iters {gres.iters} "
            f"first solve {gsolve_ms:.1f} ms launches {g_launches} "
            f"(expected {want}); launches between projections {g_gaps}; "
            f"peak memory above the {held / 2**30:.2f} GiB held before "
            f"{gpeak:.2f} GiB; true relative residual (plain "
            f"operator, f64) {g_true:.3e}")
        if gres.iters != GMRES_ITERS or g_launches["stencil_spmv"] != want:
            fail(f"GMRES {label}: {gres.iters} iterations, launches "
                 f"{g_launches}")
        gref, gplain_ms = plain_run(gstep, *gargs)
        grel_x, _ = rel_err(gres.x, gref.x)
        log(f"GMRES {label} plain reference: iters {gref.iters} solve "
            f"{gplain_ms:.1f} ms; max|Δx|/max|x| = {grel_x:.3e} (tol "
            f"{xtol:.0e})")
        if gref.iters != gres.iters or not grel_x <= xtol:
            fail(f"GMRES {label}: kernel and plain runs differ: iters "
                 f"{gres.iters} vs {gref.iters}, x {grel_x:.3e}")
        del gref, gres
        gmres_runs[label] = dict(
            step=gstep, args=gargs, first=gsolve_ms, plain=gplain_ms,
            warm=warm(gstep, *gargs), peak=gpeak, launches=g_launches,
            per=g_per)

    # -- 7h. AMG-preconditioned GMRES(30) on the CG path's hierarchy --------
    astep, (ab, ast) = gmres_entry(amg=amg)
    ares, asolve_ms, a_launches, a_per, a_gaps = run_marked(
        astep, (ab, ast), SaAmg, "apply_state", cg_kernels)
    aiters = int(ares.iters)
    a_true = true_residual(ares.x, ab)
    log(f"AMG-GMRES(30) path {GRID} f32, rtol {RTOL}: converged "
        f"{bool(ares.converged)} iters {aiters} first solve {asolve_ms:.1f} ms "
        f"launches {a_launches}; launches between preconditioner calls "
        f"{a_gaps}; true relative residual (plain operator, f64) "
        f"{a_true:.3e}")
    if not bool(ares.converged) or not a_true <= RTOL:
        fail(f"AMG-GMRES: converged {bool(ares.converged)}, true residual "
             f"{a_true:.3e}")
    for name, count in a_launches.items():
        if count == 0:
            fail(f"AMG-GMRES path never launched {name}")
    aref, aplain_ms = plain_run(astep, ab, ast)
    arel_x, _ = rel_err(ares.x, aref.x)
    log(f"AMG-GMRES plain reference: converged {bool(aref.converged)} iters "
        f"{int(aref.iters)} solve {aplain_ms:.1f} ms; max|Δx|/max|x| = "
        f"{arel_x:.3e}")
    if abs(int(aref.iters) - aiters) > 1:
        fail(f"AMG-GMRES iteration counts {aiters} vs {int(aref.iters)}")
    del aref, ares
    awarm_ms = warm(astep, ab, ast)

    # -- 7i. BASELINE config 2 at its stated size, and the GMRES variants ---
    grid2c = "x".join(map(str, CONFIG2_DIMS))
    t0 = time.perf_counter()
    c2step, (c2b,) = bsr_gmres_entry(dims=CONFIG2_DIMS, device="cuda",
                                     history=True)
    torch.cuda.synchronize()
    c2_setup_s = time.perf_counter() - t0
    c2csr = csr_f64(laplace3d(*CONFIG2_DIMS))
    zero(all_kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    c2res = c2step(c2b)
    torch.cuda.synchronize()
    c2solve_ms = (time.perf_counter() - t0) * 1e3
    c2_launches = {k: v for k, v in counts(all_kernels).items() if v}
    hist = c2res.history.cpu().numpy()
    col_iters = [int(np.flatnonzero(np.isfinite(hist[:, c]))[-1])
                 for c in range(hist.shape[1])]
    c2_true = [host_residual(c2csr, c2res.x[:, c], c2b[:, c])
               for c in range(c2b.shape[1])]
    log(f"BASELINE config 2 (Laplace3D {grid2c} BSR b=4, Relaxation, "
        f"GMRES(30), nrhs {c2b.shape[1]}, f64, rtol 1e-8): set-up "
        f"{c2_setup_s:.2f} s; converged {c2res.converged.tolist()} iters "
        f"per column {col_iters} (max {c2res.iters}); first solve "
        f"{c2solve_ms:.1f} ms; kernel launches {c2_launches or 'none'}; true "
        f"relative residuals (host CSR, f64) "
        f"{[f'{r:.3e}' for r in c2_true]}")
    if not bool(c2res.converged.all()) or max(c2_true) > CONFIG2_RTOL:
        fail(f"config 2: converged {c2res.converged.tolist()}, true "
             f"residuals {c2_true}")
    if max(col_iters) != c2res.iters:
        fail(f"config 2: column iterations {col_iters}, iters {c2res.iters}")
    c2warm_ms = warm(c2step, c2b)
    c2_variants = {}
    col0 = c2b[:, :1].contiguous()
    for solver in ("fgmres", "single_reduce", "pipeline"):
        vstep, _ = bsr_gmres_entry(dims=CONFIG2_DIMS, device="cuda",
                                   solver=solver)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vres = vstep(col0)
        torch.cuda.synchronize()
        vms = (time.perf_counter() - t0) * 1e3
        v_true = host_residual(c2csr, vres.x[:, 0], col0[:, 0])
        log(f"config 2 column 0, {solver}: converged "
            f"{bool(vres.converged.all())} iters {vres.iters} solve "
            f"{vms:.1f} ms; true relative residual (host CSR, f64) "
            f"{v_true:.3e}")
        if not bool(vres.converged.all()) or not v_true <= CONFIG2_RTOL:
            fail(f"config 2 {solver}: converged {vres.converged.tolist()}, "
                 f"true residual {v_true:.3e}")
        c2_variants[solver] = (vres.iters, vms, vstep)

    # -- 8. timings at the main paths' shapes --------------------------------
    torch.backends.cudnn.allow_tf32 = False
    n0, n1, nd = fine.n_rows_pad, a1.n_rows_pad, len(a1.offsets)
    nnz1 = int((a1.data != 0).sum())
    x0 = randn(n0, torch.float32, seed=30)
    x0k = randn((n0, NRHS), torch.float32, seed=31)
    x0b = x0k[:fine.n_rows].T.contiguous()  # the batch layout of conv3d
    x1k = randn((n1, NRHS), torch.float32, seed=32)
    p16 = randn((4096, NRHS), torch.float32, seed=33)
    g16 = with_floor(p16.T @ p16)
    eye16 = torch.eye(NRHS, device="cuda")
    # the library calls sum in another order than the kernels, hence 1e-5
    conv, conv_k = stencil_conv(fine), stencil_conv(fine, NRHS)
    check("conv3d library call vs stencil", conv(x0).reshape(-1),
          stencil_spmv_plain(fine, x0)[:fine.n_rows], 1e-5)
    check("conv3d batch-of-k library call vs stencil SpMM",
          conv_k(x0b).reshape(NRHS, -1).T,
          stencil_spmv_plain(fine, x0k)[:fine.n_rows], 1e-5)
    def poly_flops(stages):
        """Operations of the stage chain on the fine grid: 2 per stencil
        term and 1 for α, 2 each for the β, γ and ζ terms."""
        return sum((2 * fine.nnz + n0 if a else 0)
                   + 2 * n0 * ((bt != 0) + (g != 0) + (z != 0))
                   for a, bt, g, z in stages)

    zero0 = torch.zeros_like(x0)
    w_x0 = stencil_spmv(fine, x0)
    pq = randn((2, n0), torch.float32, seed=34)
    cg_state = (zero0, x0, w_x0, pq[0], pq[1], torch.stack(
        [x0 @ x0, x0 @ w_x0, x0 @ x0 * 1.25, zero0[0] + 0.5]).reshape(1, 4))
    csr = dia_as_csr(a1)
    check("sparse CSR library call vs dia", csr @ x1,
          dia_spmv_plain(a1, x1), 1e-5)
    check("sparse CSR @ dense library call vs dia SpMM", csr @ x1k,
          dia_spmv_plain(a1, x1k), 1e-5)

    def chol_library():
        l, _ = torch.linalg.cholesky_ex(g16)
        return torch.linalg.solve_triangular(l, eye16, upper=False)

    check("cholesky_ex + solve_triangular library call vs chol_inv_small",
          chol_library(), chol_inv_small_plain(g16)[1], 1e-4)
    xe0 = bdia_x(a0, 1, 550)
    xp3 = bdia_x(a3, 1, 551, planes=True)
    x3 = bdia_x(a3, 1, 551)
    csr_e0, csr3 = bdia_as_csr(a0), bdia_as_csr(a3)
    check("sparse CSR library call vs bdia (elasticity level 0)",
          csr_e0 @ xe0, bdia_spmv_plain(a0, xe0), 1e-5)
    check("sparse CSR library call vs bdia (plane CG operator)", csr3 @ x3,
          bdia_spmv_plain(a3, x3), 1e-5)

    def nonzeros(a):
        return int((a.data != 0).sum())
    rows = [
        dict(name="stencil_spmv", source="stencil_spmv.cu",
             replaces="stencil_op.py:475", also_replaces="stencil_op.py:702",
             shape=f"{GRID} f32", bytes=2 * n0 * 4, flops=2 * fine.nnz,
             kernel=lambda: stencil_spmv(fine, x0),
             plain=lambda: stencil_spmv_plain(fine, x0),
             library=lambda: conv(x0)),
        dict(name="dia_spmv", source="dia_spmv.cu",
             replaces="dia_spmv.py:273", also_replaces="dia_spmv.py:524",
             shape=f"level 1, {n1} rows x {nd} diags f32",
             bytes=(nd + 2) * n1 * 4, flops=2 * nnz1,
             kernel=lambda: dia_spmv(a1, x1),
             plain=lambda: dia_spmv_plain(a1, x1),
             library=lambda: csr @ x1),
        dict(name="stencil_spmm", source="stencil_spmv.cu",
             replaces="stencil_op.py:654", also_replaces=None,
             shape=f"{GRID} x k={NRHS} f32 (library: conv3d on a "
                   f"({NRHS}, 1, {', '.join(map(str, DIMS[::-1]))}) batch)",
             bytes=2 * n0 * NRHS * 4, flops=2 * fine.nnz * NRHS,
             kernel=lambda: stencil_spmm(fine, x0k),
             plain=lambda: stencil_spmv_plain(fine, x0k),
             library=lambda: conv_k(x0b)),
        dict(name="dia_spmm", source="dia_spmv.cu",
             replaces="dia_spmv.py:273", also_replaces="dia_spmv.py:430",
             shape=f"level 1, {n1} rows x {nd} diags x k={NRHS} f32",
             bytes=(nd + 2 * NRHS) * n1 * 4, flops=2 * nnz1 * NRHS,
             kernel=lambda: dia_spmm(a1, x1k),
             plain=lambda: dia_spmv_plain(a1, x1k),
             library=lambda: csr @ x1k),
        dict(name="chol_inv_small", source="chol_inv_small.cu",
             replaces="smalldense.py:123", also_replaces=None,
             shape=f"k={NRHS} f32",
             bytes=3 * NRHS * NRHS * 4, flops=2 * NRHS ** 3 // 3,
             kernel=lambda: chol_inv_small(g16),
             plain=lambda: chol_inv_small_plain(g16),
             library=chol_library),
        # no single PyTorch call computes a stencil polynomial or a fused
        # CG iteration: library_ms is null for the last three rows
        dict(name="stencil_poly", source="stencil_poly.cu",
             replaces="stencil_poly.py:336", also_replaces=None,
             shape=f"{GRID} f32, Chebyshev s=3 (u_s only)",
             bytes=2 * n0 * 4, flops=poly_flops(cheb3),
             kernel=lambda: stencil_poly_apply(fine, cheb3, x0),
             plain=lambda: stencil_poly_plain(fine, cheb3, x0),
             library=None),
        dict(name="stencil_powers", source="stencil_poly.cu",
             replaces="stencil_poly.py:336", also_replaces=None,
             shape=f"{GRID} f32, monomial s=4 (all outputs)",
             bytes=(1 + 4) * n0 * 4, flops=poly_flops(mono4),
             kernel=lambda: stencil_powers_apply(fine, mono4, x0),
             plain=lambda: stencil_powers_plain(fine, mono4, x0),
             library=None),
        dict(name="cg_fused", source="cg_fused.cu",
             replaces="cg_fused.py:234", also_replaces=None,
             shape=f"{GRID} f32, one iteration",
             bytes=10 * n0 * 4, flops=12 * n0 + 6 * fine.nnz,
             kernel=lambda: cg_fused_iteration(fine, *cg_state),
             plain=lambda: cg_fused_iteration_plain(fine, *cg_state),
             library=None),
        # the BDIA kernel on its two paths: interleaved k = 1 on the AMG
        # hierarchy (its level 0 here, the other levels logged below) and
        # packed planes in the plane-layout CG
        dict(name="bdia_spmv", source="bdia_spmv.cu",
             replaces="bdia_spmv.py:176", also_replaces=None,
             shape=f"elasticity {grid_e} level 0: b=3, {len(a0.offsets)} "
                   f"offsets, {a0.nbr_pad} block rows, interleaved, f32",
             bytes=bdia_bytes(a0, 1), flops=2 * nonzeros(a0),
             kernel=lambda: bdia_spmv(a0, xe0),
             plain=lambda: bdia_spmv_plain(a0, xe0),
             library=lambda: csr_e0 @ xe0),
        dict(name="bdia_spmm", source="bdia_spmv.cu",
             replaces="bdia_spmv.py:176", also_replaces=None,
             shape=f"elasticity {grid_p}: b=3, {len(a3.offsets)} offsets, "
                   f"{a3.nbr_pad} block rows, planes k=1, f32",
             bytes=bdia_bytes(a3, 1), flops=2 * nonzeros(a3),
             kernel=lambda: bdia_spmm(a3, xp3, layout="planes"),
             plain=lambda: bdia_planes_plain(a3, xp3),
             library=lambda: csr3 @ x3),
    ]
    # each row's counts come from the path that runs it (CG and block rows
    # from their own paths)
    launches = {**f_launches, **s_launches, **c_launches, **cg_launches,
                **b_launches, **e_launches, **p_launches}
    # the plane CG has no preconditioner to mark an iteration: its launches
    # per iteration are its launches over its iterations
    p_per = {"bdia_spmm": p_launches["bdia_spmm"] / PLANE_ITERS}
    per_step = {**f_per, **s_per, **c_per, **cg_per, **b_per, **e_per,
                **p_per}
    # fused kernels the polynomial wrappers launched on their own paths
    fused_launches = {"stencil_poly": c_fused, "stencil_powers": s_fused}
    # the empty kernel and chol_inv_small at the block path's k and at 32:
    # device time (graph replays) and host path
    empty_ms = graph_ms(lambda: smalldense.empty_launch(x0.device))
    empty_host_ms = time_ms(lambda: smalldense.empty_launch(x0.device))
    p32 = randn((4096, 32), torch.float32, seed=35)
    g32 = with_floor(p32.T @ p32)
    chol32_ms = graph_ms(lambda: chol_inv_small(g32))
    chol32_host_ms = time_ms(lambda: chol_inv_small(g32))
    log(f"empty kernel (launch floor for chol_inv_small): {empty_ms:.4f} ms "
        f"graph replay, {empty_host_ms:.4f} ms host path; chol_inv_small "
        f"k=32 f32: {chol32_ms:.4f} ms graph replay, {chol32_host_ms:.4f} "
        "ms host path")
    log(f"stencil_spmv plan {GRID} f32: "
        f"{stencil_op.spmv_plan(fine, 4, stencil_op.pointer_align(x0))}")
    kernels = []
    for r in rows:
        # ms, plain_ms, library_ms: device time, BATCH calls replayed from
        # one CUDA graph; host_path_ms: CUDA events around BATCH calls of
        # the kernel's wrapper from Python
        kernel_ms = graph_ms(r["kernel"])
        host_ms = time_ms(r["kernel"])
        plain_ms = graph_ms(r["plain"])
        library_ms = graph_ms(r["library"]) if r["library"] else None
        by_bytes = r["bytes"] / HBM_BYTES_PER_MS
        by_ops = r["flops"] / F32_FLOPS_PER_MS
        pkg = "smalldense.py" if r["name"] == "chol_inv_small" else None
        site = ("trilinos_tpu/ops/" if pkg else "trilinos_tpu/ops/pallas/")
        entry_ = dict(
            name=r["name"], route="cuda",
            source=f"trilinos_tpu_torch/csrc/{r['source']}",
            replaces=site + r["replaces"],
            also_replaces=(site + r["also_replaces"]
                           if r["also_replaces"] else None),
            shape=r["shape"], launches=launches[r["name"]],
            launches_per_step=per_step[r["name"]],
            max_abs_err=err[r["name"]], ms=kernel_ms, kernel_ms=kernel_ms,
            host_path_ms=host_ms, plain_ms=plain_ms,
            bound_ms=max(by_bytes, by_ops),
            bound_by="bytes" if by_bytes >= by_ops else "operations",
            library_ms=library_ms)
        if r["name"] in fused_launches:
            entry_["kernel_launches"] = fused_launches[r["name"]]
        if r["name"] == "chol_inv_small":
            entry_.update(empty_ms=empty_ms, empty_host_path_ms=empty_host_ms,
                          k32_ms=chol32_ms, k32_host_path_ms=chol32_host_ms)
        log(json.dumps(entry_))
        kernels.append(entry_)
    bf16_ms = time_ms(lambda: dia_spmv(a1_bf16, x1))
    log(f"dia_spmv bf16 data at level 1: {bf16_ms:.4f} ms, bound "
        f"{(nd * 2 + 2 * 4) * n1 / HBM_BYTES_PER_MS:.4f} ms")
    bf16k_ms = time_ms(lambda: dia_spmm(a1_bf16, x1k))
    log(f"dia_spmm bf16 data at level 1, k={NRHS}: {bf16k_ms:.4f} ms, bound "
        f"{(nd * 2 + 2 * NRHS * 4) * n1 / HBM_BYTES_PER_MS:.4f} ms")
    # the DIA SpMM at k = 16 on every level of the block path
    for i, a in enumerate(levels, start=1):
        xk = randn((a.n_rows_pad, NRHS), torch.float32, seed=80 + i)
        csr_l = dia_as_csr(a)
        nd_l = len(a.offsets)
        log(f"dia SpMM level {i} ({a.n_rows_pad} rows x {nd_l} diags, "
            f"k={NRHS}, f32): kernel "
            f"{time_ms(lambda: dia_spmm(a, xk)):.4f} ms, bound "
            f"{(nd_l + 2 * NRHS) * a.n_rows_pad * 4 / HBM_BYTES_PER_MS:.4f} "
            f"ms, launches per block solve {dia_by_rows[a.n_rows_pad]}, "
            f"sparse CSR @ {time_ms(lambda: csr_l @ xk):.4f} ms")
        del xk, csr_l

    def bsr_call(a, x):
        """torch.sparse_bsr_tensor @ x, or None where the card's PyTorch
        has no such product (logged)."""
        bsr = bdia_as_bsr(a)
        try:
            y = bsr @ x[:, None]
        except (NotImplementedError, RuntimeError) as exc:
            log(f"sparse BSR @ dense not available: {exc}")
            return None
        check("sparse BSR library call vs bdia", y[:, 0],
              bdia_spmv_plain(a, x), 1e-5)
        return lambda: bsr @ x[:, None]

    # the BDIA kernel at every shape of the two elasticity paths and the
    # JAX bench's bare apply, beside its bound, plain version and library
    # calls
    bdia_shapes = [(f"elasticity {grid_e} level {i}", a, bdia_x(a, 1, 560 + i))
                   for i, a in enumerate(el_levels)]
    bdia_shapes += [
        (f"elasticity {grid_e} level 0 bf16 data", a0_bf16, xe0),
        (f"elasticity {grid_p} interleaved", a3, x3)]
    for label, a, x in bdia_shapes:
        csr = bdia_as_csr(a) if a.dtype != torch.bfloat16 else None
        bsr = bsr_call(a, x) if csr is not None else None
        log(f"bdia {label} (b={a.block_size}, nd={len(a.offsets)}, "
            f"nbr={a.nbr_pad}, k=1): kernel "
            f"{time_ms(lambda: bdia_spmv(a, x)):.4f} ms, bound "
            f"{bdia_bytes(a, 1) / HBM_BYTES_PER_MS:.4f} ms, plain "
            f"{time_ms(lambda: bdia_spmv_plain(a, x)):.4f} ms, sparse CSR @ "
            + (f"{time_ms(lambda: csr @ x):.4f} ms" if csr is not None
               else "-") + ", sparse BSR @ "
            + (f"{time_ms(bsr):.4f} ms" if bsr else "-"))
        del csr
    for k in (1, NRHS):
        x2p = bdia_x(a2, k, 570 + k, planes=True)
        log(f"bdia elasticity2d {grid2} planes (b=2, nd={len(a2.offsets)}, "
            f"nbr={a2.nbr_pad}, k={k}): kernel "
            f"{time_ms(lambda: bdia_spmm(a2, x2p, layout='planes')):.4f} ms, "
            f"bound {bdia_bytes(a2, k) / HBM_BYTES_PER_MS:.4f} ms, plain "
            f"{time_ms(lambda: bdia_planes_plain(a2, x2p)):.4f} ms")

    def unfused(stages, keep):
        """The stage chain as stencil_spmv kernel launches and plain
        axpys (256³ has no pad rows)."""
        prev2, prev, outs = zero0, x0, []
        for a, bt, g, z in stages:
            u = a * stencil_spmv(fine, prev) if a else zero0
            if bt:
                u = u + bt * prev
            if g:
                u = u + g * prev2
            if z:
                u = u + z * x0
            prev2, prev = prev, u
            if keep:
                outs.append(u)
        return outs or prev

    def unfused_cg():
        """One single-reduce iteration as a stencil_spmv launch and plain
        vector ops: the unfused sequence cg_fused replaces."""
        _, r_, w_, p_, q_, sc = cg_state
        beta, alpha = sc[0, 0] / sc[0, 2], sc[0, 3]
        p2, q2 = r_ + beta * p_, w_ + beta * q_
        r2 = r_ - alpha * q2
        w2 = stencil_spmv(fine, r2)
        return zero0 + alpha * p2, torch.stack([r2 @ r2, r2 @ w2])

    for label, fn in (("stencil_poly Chebyshev s=3", lambda: unfused(
            cheb3, False)), ("stencil_powers monomial s=4", lambda: unfused(
            mono4, True)), ("cg_fused iteration", unfused_cg)):
        log(f"unfused sequence for {label} at {GRID} f32 (stencil_spmv "
            f"kernel + plain vector ops): {time_ms(fn):.4f} ms")
    log(f"CG solve: {warm_ms:.2f} ms wall, {warm_ms / max(iters, 1):.3f} "
        f"ms/iter over {iters} iterations (first solve {solve_ms:.1f} ms; "
        f"plain versions {plain_solve_ms:.1f} ms)")
    log(f"block solve: {bwarm_ms:.2f} ms wall, "
        f"{bwarm_ms / max(steps, 1):.3f} ms/block step over {steps} block "
        f"steps of {NRHS} right-hand sides (first solve {bsolve_ms:.1f} ms; "
        f"plain versions {bplain_ms:.1f} ms); launches per block step "
        f"{b_per}; peak memory {bpeak:.2f} GiB (plain {bplain_peak:.2f} GiB)")
    log(f"Chebyshev AMG-PCG solve: {cwarm_ms:.2f} ms wall, "
        f"{cwarm_ms / max(citers, 1):.3f} ms/iter over {citers} iterations "
        f"(first solve {csolve_ms:.1f} ms; plain versions {cplain_ms:.1f} "
        f"ms); launches per iteration {c_per}")
    log(f"s-step GMRES solve: {swarm_ms:.2f} ms wall, "
        f"{swarm_ms / sres.iters:.3f} ms per basis vector over {sres.iters} "
        f"(first solve {ssolve_ms:.1f} ms; plain versions {splain_ms:.1f} "
        f"ms); launches per block of 4 {s_per}")
    log(f"elasticity {grid_e} AMG-PCG: set-up {el_setup_s:.2f} "
        f"s; solve {ewarm_ms:.2f} ms wall, {ewarm_ms / max(eiters, 1):.3f} "
        f"ms/iter over {eiters} iterations (first solve {esolve_ms:.1f} ms; "
        f"plain versions {eplain_ms:.1f} ms); launches per iteration "
        f"{e_per}, per solve {e_launches}")
    log(f"plane-layout CG {grid_p}: {pwarm_ms:.2f} ms wall, "
        f"{pwarm_ms / PLANE_ITERS:.4f} ms/iter over {PLANE_ITERS} iterations "
        f"(first solve {psolve_ms:.1f} ms); launches {p_launches}")
    log(f"hierarchy set-ups (native SpGEMM): {GRID} Jacobi "
        f"{jacobi_setup_s:.2f} s, Chebyshev {cheb_setup_s:.2f} s, "
        f"elasticity {grid_e} {el_setup_s:.2f} s")
    log(f"fused CG solve: {fwarm_ms:.2f} ms wall, "
        f"{fwarm_ms / max(fres.iters, 1):.4f} ms/iter over {fres.iters} "
        f"iterations (first solve {fsolve_ms:.1f} ms); launches per "
        f"iteration {f_per}")

    for label, run in gmres_runs.items():
        log(f"GMRES(30) {GRID} {label} solve: {run['warm']:.2f} ms wall, "
            f"{run['warm'] / GMRES_ITERS:.3f} ms/iter over {GMRES_ITERS} "
            f"iterations (first solve {run['first']:.1f} ms; plain versions "
            f"{run['plain']:.1f} ms); launches per iteration {run['per']}; "
            f"the solve's own peak memory {run['peak']:.2f} GiB")
    log(f"AMG-GMRES(30) solve: {awarm_ms:.2f} ms wall, "
        f"{awarm_ms / max(aiters, 1):.3f} ms/iter over {aiters} iterations "
        f"(first solve {asolve_ms:.1f} ms; plain versions {aplain_ms:.1f} "
        f"ms); launches per iteration {a_per}")
    log(f"BASELINE config 2 solve ({grid2c}, nrhs {c2b.shape[1]}, f64): "
        f"{c2warm_ms:.2f} ms wall, {c2warm_ms / max(c2res.iters, 1):.4f} "
        f"ms/iter over {c2res.iters} iterations (first solve "
        f"{c2solve_ms:.1f} ms); column 0 variants " + ", ".join(
            f"{k} {it} iters {ms:.1f} ms" for k, (it, ms, _) in
            c2_variants.items()))

    # -- 9. one solve of each path under the profiler: device time by kernel
    # (last, so that it cannot disturb the timings above)
    profile("CG solve", lambda: step(b, state), focus="stencil_kernel")
    profile("block solve", lambda: bstep(bb, bstate))
    profile("Chebyshev AMG-PCG solve", lambda: cstep(cb, cstate),
            focus="stencil_kernel")
    profile("s-step GMRES solve", lambda: sstep(sb))
    profile("fused CG solve", lambda: fstep(fb))
    profile("elasticity AMG-PCG solve", lambda: estep(eb, est))
    profile("plane-layout CG solve", lambda: pstep(pb))
    for label, run in gmres_runs.items():
        profile(f"GMRES(30) {label} solve", lambda: run["step"](*run["args"]),
                focus="stencil_kernel")
    profile("AMG-GMRES(30) solve", lambda: astep(ab, ast),
            focus="stencil_kernel")
    profile("BASELINE config 2 solve", lambda: c2step(c2b))

    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
