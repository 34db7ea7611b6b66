"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``trilinos_tpu_torch/csrc/``,
holds each against its plain PyTorch version on the card at every shape the
main paths give it, and drives both main paths on one 256³ Laplace3D
structured-AMG hierarchy:

* structured-AMG-preconditioned CG (``entry``), once through the kernels
  and once through the plain versions;
* AMG-preconditioned block GMRES, nrhs = 16, CGS2 + CholQR2
  (``block_entry``), the same two ways, one after the other.

Each path is driven with the launch counts set to 0 just before it and
read just after. It times each warm solve, times each kernel beside its
bound, its plain version and one PyTorch library call, profiles one solve
of each path (device time by kernel), and ends with one JSON line naming
the device. Any failure exits non-zero; without a CUDA device it exits
non-zero before doing anything.
"""
import collections
import json
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
# they agree to f32 rounding amplified by the factor's conditioning, not to
# the bit. Gates: kernel vs plain, and the kernel's own residuals
# ‖L·Lᵀ − g‖/‖g‖ (backward error of a Cholesky factor, a few eps) and
# max|L⁻¹·L − I| (grows with cond(L), ≤ 10 on these panels).
CHOL_TOL = {"vs_plain": 1e-4, "llt": 1e-5, "inv": 1e-4}
# the kernel and plain block solves stop at rtol 1e-5 along slightly
# different rounding, so their x agree to about the tolerance, not better
BLOCK_X_TOL = 1e-4
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
    back-to-back calls, after three warm-up calls. The batch keeps the card
    busy while the host enqueues, so launch overhead on the host does not
    count as device time."""
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


def with_floor(g):
    """g plus cholqr's diagonal floor max(10·eps·max|g|, tiny)."""
    fl = torch.clamp(10.0 * torch.finfo(g.dtype).eps * g.abs().max(),
                     min=torch.finfo(g.dtype).tiny)
    return g + fl * torch.eye(g.shape[0], device=g.device, dtype=g.dtype)


def counts(wrappers):
    return {name: fn.launches for name, fn in wrappers.items()}


def zero(wrappers):
    for fn in wrappers.values():
        fn.launches = 0


def run_marked(step, args, amg_cls, wrappers):
    """Run ``step(*args)`` with the counts set to 0, recording them at each
    preconditioner call. Returns (result, wall ms, counts, most common
    count moves between two preconditioner calls, all moves)."""
    marks = []
    apply_state = amg_cls.apply_state

    def marked(self, st, r):
        marks.append(tuple(counts(wrappers).values()))
        return apply_state(self, st, r)

    zero(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(amg_cls, "apply_state", marked):
        res = step(*args)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    gaps = collections.Counter(
        tuple(b - a for a, b in zip(m0, m1))
        for m0, m1 in zip(marks, marks[1:]))
    if not gaps:
        fail("a main path ran fewer than two preconditioner calls")
    per = dict(zip(wrappers, gaps.most_common(1)[0][0]))
    return res, ms, counts(wrappers), per, dict(gaps)


def profile(label, fn):
    """Device time by kernel and busy share of one run of ``fn``."""
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)

    from trilinos_tpu_torch.entry import block_entry, entry
    from trilinos_tpu_torch.galeri import laplace3d
    from trilinos_tpu_torch.galeri.stencils import cross3d_stencil
    from trilinos_tpu_torch.ops import (StencilOp, chol_inv_small,
                                        chol_inv_small_plain, dia_spmm,
                                        dia_spmv, dia_spmv_plain,
                                        stencil_spmm, stencil_spmv,
                                        stencil_spmv_plain)
    from trilinos_tpu_torch.ops import _build, matvec, smalldense
    from trilinos_tpu_torch.precond import SaAmg

    cg_kernels = {"stencil_spmv": stencil_spmv, "dia_spmv": dia_spmv}
    block_kernels = {"stencil_spmm": stencil_spmm, "dia_spmm": dia_spmm,
                     "chol_inv_small": chol_inv_small}
    all_kernels = {**cg_kernels, **block_kernels}

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
    for name in _build.KERNELS:
        report = (_build.BUILD_DIR / f"{name}.log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "Compiling entry" in line or "registers" in line \
                        or "spill" in line:
                    log(f"  ptxas {name}: {line.strip()}")

    # -- 3. stencil kernels against their plain versions ---------------------
    lap = cross3d_stencil(6.0, *([-1.0] * 6))
    err = dict.fromkeys(all_kernels, 0.0)
    cases = [(f"{GRID} f32", DIMS, None, torch.float32),
             ("100^3 f32", (100, 100, 100), None, torch.float32),
             ("16^3 f32 pad rows", (16, 16, 16), 4096 + 1024, torch.float32),
             ("128^3 f64", (128, 128, 128), None, torch.float64)]
    for i, (label, dims, npad, dt) in enumerate(cases):
        op = StencilOp.create(dims, lap, n_rows_pad=npad)
        x = randn(op.n_rows_pad, dt, seed=10 + i)
        y = stencil_spmv(op, x)
        torch.cuda.synchronize()
        err["stencil_spmv"] = max(err["stencil_spmv"], check(
            f"stencil {label}", y, stencil_spmv_plain(op, x), TOL[dt]))
    mv_cases = [(f"{GRID} k={NRHS}", DIMS, NRHS)] + [
        (f"10x10x8 (800 rows in 1024) k={k}", (10, 10, 8), k)
        for k in (1, 3, NRHS)]
    for i, (label, dims, k) in enumerate(mv_cases):
        op = StencilOp.create(dims, lap)
        x = randn((op.n_rows_pad, k), torch.float32, seed=40 + i)
        y = stencil_spmm(op, x)
        torch.cuda.synchronize()
        err["stencil_spmm"] = max(err["stencil_spmm"], check(
            f"stencil SpMM {label} f32", y, stencil_spmv_plain(op, x),
            TOL[torch.float32]))
        del x, y

    # -- 4. one hierarchy for both paths; DIA kernels on every level ---------
    t0 = time.perf_counter()
    fine = laplace3d(*DIMS, dtype=np.float32, fmt="stencil")
    amg = SaAmg(fine, {"dtype": np.float32}, device="cuda").compute()
    step, (b, state) = entry(amg=amg)
    torch.cuda.synchronize()
    log(f"setup {GRID} hierarchy: {time.perf_counter() - t0:.2f} s; levels "
        + " -> ".join(type(lv["a"]).__name__ + str(
            getattr(lv["a"], "offsets", ()).__len__())
            for lv in state["levels"])
        + f" -> dense {tuple(state['coarse_inv'].shape)}")
    levels = [lv["a"] for lv in state["levels"][1:]]
    bf16 = [type(a)(data=a.data.to(torch.bfloat16), offsets=a.offsets,
                    n_rows=a.n_rows, n_cols=a.n_cols, nnz=a.nnz)
            for a in levels]
    # bf16 data, f32 x and sum: both versions multiply the same widened
    # values and add in the same order, so f32's tolerance holds
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
                dia_spmv_plain(m, xk), TOL[torch.float32]))
    a1, a1_bf16 = levels[0], bf16[0]
    x1 = randn(a1.n_rows_pad, torch.float32, seed=20)
    check("dia level-1 bf16 data", dia_spmv(a1_bf16, x1),
          dia_spmv_plain(a1_bf16, x1), TOL[torch.float32])

    # -- 5. chol_inv_small for every k it takes ------------------------------
    for k in range(1, smalldense.UNROLL_MAX + 1):
        p = randn((4096, k), torch.float32, seed=200 + k)
        for label, panel in (("random", p), ("scaled", p * torch.logspace(
                -0.5, 0.5, k, device="cuda"))):
            g = with_floor(panel.T @ panel)
            l, linv = chol_inv_small(g)
            lp, linvp = chol_inv_small_plain(g)
            torch.cuda.synchronize()
            worst = max(rel_err(l, lp)[0], rel_err(linv, linvp)[0])
            err["chol_inv_small"] = max(err["chol_inv_small"],
                                        rel_err(l, lp)[1],
                                        rel_err(linv, linvp)[1])
            llt = float(torch.linalg.norm(l @ l.T - g) / torch.linalg.norm(g))
            inv = float((linv @ l - torch.eye(k, device="cuda")).abs().max())
            if not (worst <= CHOL_TOL["vs_plain"] and llt <= CHOL_TOL["llt"]
                    and inv <= CHOL_TOL["inv"]):
                fail(f"chol_inv_small k={k} {label}: vs plain {worst:.2e}, "
                     f"LLt {llt:.2e}, inv {inv:.2e} (tol {CHOL_TOL})")
            if k in (1, 16, 32):
                log(f"check chol_inv_small k={k} {label}: vs plain "
                    f"{worst:.3e}, ‖LLᵀ−g‖/‖g‖ {llt:.3e}, "
                    f"max|L⁻¹L−I| {inv:.3e} (tol {CHOL_TOL})")
    log(f"check chol_inv_small k=1..32 (random and scaled panels): all "
        f"within {CHOL_TOL}")

    # -- 6. the CG path, then the plain versions as reference ----------------
    res, solve_ms, cg_launches, cg_per, cg_gaps = run_marked(
        step, (b, state), SaAmg, cg_kernels)
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
        mock.patch.object(matvec, "stencil_spmv", stencil_spmv_plain),
        mock.patch.object(matvec, "dia_spmv", dia_spmv_plain),
        mock.patch.object(smalldense, "chol_inv_small",
                          chol_inv_small_plain))

    def plain_run(fn, *args):
        """fn(*args) with the plain versions patched in for every kernel;
        fails if a kernel launched. Returns (result, wall ms)."""
        before = counts(all_kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with plain_patches[0], plain_patches[1], plain_patches[2]:
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
    bres, bsolve_ms, b_launches, b_per, b_gaps = run_marked(
        bstep, (bb, bstate), SaAmg, block_kernels)
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
    ]
    launches = {**cg_launches, **b_launches}
    per_step = {**cg_per, **b_per}
    kernels = []
    for r in rows:
        kernel_ms = time_ms(r["kernel"])
        plain_ms = time_ms(r["plain"])
        library_ms = time_ms(r["library"])
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
            plain_ms=plain_ms, bound_ms=max(by_bytes, by_ops),
            bound_by="bytes" if by_bytes >= by_ops else "operations",
            library_ms=library_ms)
        log(json.dumps(entry_))
        kernels.append(entry_)
    bf16_ms = time_ms(lambda: dia_spmv(a1_bf16, x1))
    log(f"dia_spmv bf16 data at level 1: {bf16_ms:.4f} ms, bound "
        f"{(nd * 2 + 2 * 4) * n1 / HBM_BYTES_PER_MS:.4f} ms")
    bf16k_ms = time_ms(lambda: dia_spmm(a1_bf16, x1k))
    log(f"dia_spmm bf16 data at level 1, k={NRHS}: {bf16k_ms:.4f} ms, bound "
        f"{(nd * 2 + 2 * NRHS * 4) * n1 / HBM_BYTES_PER_MS:.4f} ms")
    empty_ms = time_ms(lambda: smalldense.empty_launch(x0.device))
    log(f"empty kernel (launch floor for chol_inv_small): {empty_ms:.4f} ms")
    log(f"CG solve: {warm_ms:.2f} ms wall, {warm_ms / max(iters, 1):.3f} "
        f"ms/iter over {iters} iterations (first solve {solve_ms:.1f} ms; "
        f"plain versions {plain_solve_ms:.1f} ms)")
    log(f"block solve: {bwarm_ms:.2f} ms wall, "
        f"{bwarm_ms / max(steps, 1):.3f} ms/block step over {steps} block "
        f"steps of {NRHS} right-hand sides (first solve {bsolve_ms:.1f} ms; "
        f"plain versions {bplain_ms:.1f} ms); launches per block step "
        f"{b_per}; peak memory {bpeak:.2f} GiB (plain {bplain_peak:.2f} GiB)")

    # -- 9. one solve of each path under the profiler: device time by kernel
    # (last, so that it cannot disturb the timings above)
    profile("CG solve", lambda: step(b, state))
    profile("block solve", lambda: bstep(bb, bstate))

    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
