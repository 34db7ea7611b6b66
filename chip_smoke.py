"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``trilinos_tpu_torch/csrc/``,
holds each against its plain PyTorch version on the card at every shape the
main path gives it, drives the main path (structured-AMG-preconditioned CG
on a 256³ Laplace3D stencil) once through the kernels and once through the
plain versions, times the warm solve and profiles one more (device time by
kernel), times each kernel beside its bandwidth bound, its plain version
and one PyTorch library call, and ends with one JSON line naming the
device. Any failure exits non-zero; without a CUDA device it exits
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
RTOL = 1e-5  # the solve's tolerance in entry(); the true residual's gate
HBM_BYTES_PER_MS = 3.35e12 / 1e3  # H100 SXM device memory, 3.35 TB/s
TOL = {torch.float32: 1e-6, torch.float64: 1e-13}
BATCH, SAMPLES = 10, 25


def log(*parts):
    print(*parts, flush=True)


def rel_err(got, want):
    """(max |Δ| / max |want|, max |Δ|)."""
    err = float((got.double() - want.double()).abs().max())
    return err / float(want.double().abs().max()), err


def check(name, got, want, tol):
    rel, err = rel_err(got, want)
    log(f"check {name}: max|Δ|/max|y| = {rel:.3e} (tol {tol:.0e})")
    if not rel <= tol:
        raise SystemExit(f"FAIL {name}: {rel:.3e} > {tol:.0e}")
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


def randn(n, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(n, generator=g, device="cuda", dtype=dtype)


def stencil_conv(op):
    """The 3×3×3 convolution that computes the same stencil apply."""
    w = torch.zeros((1, 1, 3, 3, 3), device="cuda")
    for (dx, dy, dz), c in zip(op.offsets, op.coeffs):
        w[0, 0, dz + 1, dy + 1, dx + 1] = c
    nx, ny, nz = op.dims

    def run(x):
        v = x[:op.n_rows].view(1, 1, nz, ny, nx)
        return torch.nn.functional.conv3d(v, w, padding=1)

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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)

    from trilinos_tpu_torch.entry import entry
    from trilinos_tpu_torch.galeri import laplace3d
    from trilinos_tpu_torch.galeri.stencils import cross3d_stencil
    from trilinos_tpu_torch.ops import (StencilOp, dia_spmv, dia_spmv_plain,
                                        stencil_spmv, stencil_spmv_plain)
    from trilinos_tpu_torch.ops import _build, matvec
    from trilinos_tpu_torch.precond import SaAmg

    # -- 1. the card ---------------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"({', '.join(f'{k} {v:.2f} s' for k, v in built.items())})")
    for name in _build.KERNELS:
        report = (_build.BUILD_DIR / f"{name}.log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {name}: {line.strip()}")

    # -- 3. kernels against their plain versions -----------------------------
    lap = cross3d_stencil(6.0, *([-1.0] * 6))
    err = {"stencil_spmv": 0.0, "dia_spmv": 0.0}
    cases = [("256^3 f32", DIMS, None, torch.float32),
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

    t0 = time.perf_counter()
    step, (b, state) = entry(dims=DIMS, dtype=np.float32, device="cuda")
    torch.cuda.synchronize()
    log(f"setup 256^3 hierarchy: {time.perf_counter() - t0:.2f} s; levels "
        + " -> ".join(type(lv["a"]).__name__ + str(
            getattr(lv["a"], "offsets", ()).__len__())
            for lv in state["levels"])
        + f" -> dense {tuple(state['coarse_inv'].shape)}")
    # every coarse level the main path runs the DIA kernel on
    for i, lv in enumerate(state["levels"][1:], start=1):
        a = lv["a"]
        xl = randn(a.n_rows_pad, torch.float32, seed=19 + i)
        err["dia_spmv"] = max(err["dia_spmv"], check(
            f"dia level-{i} {a.n_rows_pad} rows x {len(a.offsets)} diags "
            "f32", dia_spmv(a, xl), dia_spmv_plain(a, xl),
            TOL[torch.float32]))
    a1 = state["levels"][1]["a"]
    x1 = randn(a1.n_rows_pad, torch.float32, seed=20)
    a1_bf16 = type(a1)(data=a1.data.to(torch.bfloat16), offsets=a1.offsets,
                       n_rows=a1.n_rows, n_cols=a1.n_cols, nnz=a1.nnz)
    # bf16 data, f32 x and sum: both versions multiply the same widened
    # values and add in the same order, so f32's tolerance holds
    check("dia level-1 bf16 data", dia_spmv(a1_bf16, x1),
          dia_spmv_plain(a1_bf16, x1), TOL[torch.float32])

    # -- 4. the main path, then the plain versions as reference --------------
    # the counts at each preconditioner call: between two calls lies one CG
    # iteration, op(p) and one cycle
    marks = []
    apply_state = SaAmg.apply_state

    def marked_apply_state(self, st, r):
        marks.append((stencil_spmv.launches, dia_spmv.launches))
        return apply_state(self, st, r)

    stencil_spmv.launches = 0
    dia_spmv.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(SaAmg, "apply_state", marked_apply_state):
        res = step(b, state)
    torch.cuda.synchronize()
    solve_ms = (time.perf_counter() - t0) * 1e3
    launches = {"stencil_spmv": stencil_spmv.launches,
                "dia_spmv": dia_spmv.launches}
    iters = int(res.iters)
    gaps = collections.Counter(
        (s1 - s0, d1 - d0) for (s0, d0), (s1, d1) in zip(marks, marks[1:]))
    if not gaps:
        raise SystemExit("FAIL main path ran fewer than two cycles")
    (per_iter_st, per_iter_dia), _ = gaps.most_common(1)[0]
    per_iter = {"stencil_spmv": per_iter_st, "dia_spmv": per_iter_dia}
    log(f"main path: converged {bool(res.converged)} iters {iters} "
        f"first solve {solve_ms:.1f} ms launches {launches}; launches "
        f"between preconditioner calls {dict(gaps)}")
    if not bool(res.converged):
        raise SystemExit("FAIL main path did not converge")
    for name, count in launches.items():
        if count == 0:
            raise SystemExit(f"FAIL main path never launched {name}")

    fine = laplace3d(*DIMS, dtype=np.float32, fmt="stencil")
    b64 = b.double()
    true_rel = float(torch.linalg.vector_norm(
        b64 - stencil_spmv_plain(fine, res.x.double()))
        / torch.linalg.vector_norm(b64))
    log(f"true relative residual (plain operator, f64): {true_rel:.3e}")
    if not true_rel <= RTOL:
        raise SystemExit(f"FAIL true residual {true_rel:.3e} > {RTOL}")

    # the reference run calls the plain versions in place of the wrappers
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(matvec, "stencil_spmv", stencil_spmv_plain), \
            mock.patch.object(matvec, "dia_spmv", dia_spmv_plain):
        ref = step(b, state)
    torch.cuda.synchronize()
    plain_solve_ms = (time.perf_counter() - t0) * 1e3
    if stencil_spmv.launches != launches["stencil_spmv"] or \
            dia_spmv.launches != launches["dia_spmv"]:
        raise SystemExit("FAIL the plain reference run launched a kernel")
    rel_x, _ = rel_err(res.x, ref.x)
    log(f"plain reference: converged {bool(ref.converged)} iters "
        f"{int(ref.iters)} solve {plain_solve_ms:.1f} ms; "
        f"max|Δx|/max|x| = {rel_x:.3e}")
    if abs(int(ref.iters) - iters) > 1:
        raise SystemExit(f"FAIL iteration counts {iters} vs "
                         f"{int(ref.iters)}")
    if not rel_x <= TOL[torch.float32]:
        raise SystemExit(f"FAIL kernel and plain solves differ: "
                         f"{rel_x:.3e} > {TOL[torch.float32]:.0e}")

    # the first solve pays one-time costs (library handles, lazy module
    # loading); the same solve again is the steady-state time
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(b, state)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3

    # -- 5. timings at the main path's shapes --------------------------------
    torch.backends.cudnn.allow_tf32 = False
    x0 = randn(fine.n_rows_pad, torch.float32, seed=30)
    # the library calls sum in another order than the kernels, hence 1e-5
    conv = stencil_conv(fine)
    check("conv3d library call vs stencil", conv(x0).reshape(-1),
          stencil_spmv_plain(fine, x0)[:fine.n_rows], 1e-5)
    csr = dia_as_csr(a1)
    check("sparse CSR library call vs dia", csr @ x1,
          dia_spmv_plain(a1, x1), 1e-5)
    n0, n1, nd = fine.n_rows_pad, a1.n_rows_pad, len(a1.offsets)
    rows = [
        dict(name="stencil_spmv", route="cuda",
             source="trilinos_tpu_torch/csrc/stencil_spmv.cu",
             replaces="trilinos_tpu/ops/pallas/stencil_op.py:475",
             also_replaces="trilinos_tpu/ops/pallas/stencil_op.py:702",
             shape="256^3 f32", bytes=2 * n0 * 4,
             kernel=lambda: stencil_spmv(fine, x0),
             plain=lambda: stencil_spmv_plain(fine, x0),
             library=lambda: conv(x0)),
        dict(name="dia_spmv", route="cuda",
             source="trilinos_tpu_torch/csrc/dia_spmv.cu",
             replaces="trilinos_tpu/ops/pallas/dia_spmv.py:273",
             also_replaces="trilinos_tpu/ops/pallas/dia_spmv.py:524",
             shape=f"level 1 128^3 x {nd} diags f32",
             bytes=(nd + 2) * n1 * 4,
             kernel=lambda: dia_spmv(a1, x1),
             plain=lambda: dia_spmv_plain(a1, x1),
             library=lambda: csr @ x1),
    ]
    kernels = []
    for r in rows:
        kernel_ms = time_ms(r["kernel"])
        plain_ms = time_ms(r["plain"])
        library_ms = time_ms(r["library"])
        bound_ms = r["bytes"] / HBM_BYTES_PER_MS
        entry_ = dict(
            name=r["name"], route=r["route"], source=r["source"],
            replaces=r["replaces"], also_replaces=r["also_replaces"],
            shape=r["shape"], launches=launches[r["name"]],
            launches_per_iter=per_iter[r["name"]],
            max_abs_err=err[r["name"]], ms=kernel_ms, kernel_ms=kernel_ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
            library_ms=library_ms)
        log(json.dumps(entry_))
        kernels.append(entry_)
    bf16_ms = time_ms(lambda: dia_spmv(a1_bf16, x1))
    log(f"dia_spmv bf16 data at level 1: {bf16_ms:.4f} ms, bound "
        f"{(nd * 2 + 2 * 4) * n1 / HBM_BYTES_PER_MS:.4f} ms")
    log(f"solve: {warm_ms:.2f} ms wall, {warm_ms / max(iters, 1):.3f} "
        f"ms/iter over {iters} iterations (first solve {solve_ms:.1f} ms; "
        f"plain versions {plain_solve_ms:.1f} ms)")

    # -- 6. one more solve under the profiler: device time by kernel -------
    # (last, so that it cannot disturb the timings above)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(b, state)
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = {e.key: (e.self_device_time_total / 1e3, e.count)
                 for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA}
    busy_ms = sum(ms for ms, _ in by_kernel.values())
    log(f"profiled solve: {busy_ms:.2f} ms of device time in "
        f"{profiled_ms:.2f} ms wall (busy share "
        f"{busy_ms / profiled_ms:.3f}); by kernel:")
    for key, (ms, count) in sorted(by_kernel.items(),
                                   key=lambda kv: -kv[1][0])[:12]:
        log(f"  {ms:8.3f} ms {count:5d} launches  {key[:100]}")

    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
