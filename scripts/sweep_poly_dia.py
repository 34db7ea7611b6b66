"""Sweep the design levers of the fused stencil polynomial and the DIA SpMM
on one NVIDIA card.

    python3 scripts/sweep_poly_dia.py

At the paths' shapes (the 256³ Laplace3D stencil in f32; the four DIA
levels of its AMG hierarchy at k = 16) it times, with CUDA events as
``chip_smoke.py`` does:

* the polynomial (Chebyshev s = 3 u_s, monomial s = 4 all outputs) over
  its plan's input region and z-chunk target;
* kernel variants built from edited copies of ``csrc/stencil_poly.cu``
  and ``csrc/dia_spmv.cu`` (into the git-ignored ``_build/variants/``):
  the generic instance in place of the 7-point cross's, the point loop
  reading the stage's flags at run time, fewer or more points in flight;
  the DIA SpMM's diagonal loop unrolled 2 or 4 times.

Every variant is held bitwise against the plain version first, and the
variants run in turns (shipped, variants, variants reversed, shipped).
Prints one line per measurement, then the card's name and power limit.
Exits non-zero without a CUDA device.
"""
import importlib
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

P, D = "stencil_poly.cu", "dia_spmv.cu"
# name -> (file, text, replacement) edits of the committed sources
VARIANTS = {
    "poly: generic instance for the 7-point cross": [
        (P, "bool cross = n_terms == 7 && a.pitch == TT_CROSS_PITCH;",
         "bool cross = false;")],
    "poly: stage flags read at run time": [
        (P, "if (!a.from_x) {", "if (true) {")],
    "poly: 1 point in flight": [
        (P, "poly_kernel<T, 7, 2, 2, true>", "poly_kernel<T, 7, 1, 1, true>")],
    "poly: 8 points in flight": [
        (P, "poly_kernel<T, 7, 2, 2, true>", "poly_kernel<T, 7, 4, 2, true>")],
    "dia: diagonal loop unrolled 2": [
        (D, "  for (int d = 0; d < o.n; ++d) {\n    const long long j = i + "
            "o.off[d];\n    if (j >= 0 && j < n_pad) {",
         "#pragma unroll 2\n  for (int d = 0; d < o.n; ++d) {\n    const "
         "long long j = i + o.off[d];\n    if (j >= 0 && j < n_pad) {")],
    "dia: diagonal loop unrolled 4": [
        (D, "  for (int d = 0; d < o.n; ++d) {\n    const long long j = i + "
            "o.off[d];\n    if (j >= 0 && j < n_pad) {",
         "#pragma unroll 4\n  for (int d = 0; d < o.n; ++d) {\n    const "
         "long long j = i + o.off[d];\n    if (j >= 0 && j < n_pad) {")],
}
REGIONS = [(64, 16), (64, 24), (64, 32), (64, 48)]
TARGETS = [512, 1024]


def main():
    if not torch.cuda.is_available():
        print("sweep_poly_dia: no CUDA device", file=sys.stderr)
        sys.exit(2)
    from chip_smoke import log, randn, time_ms
    from trilinos_tpu_torch.galeri import laplace3d
    from trilinos_tpu_torch.ops import _build
    from trilinos_tpu_torch.ops.stencil_poly import (monomial_stages,
                                                     stencil_chebyshev_setup)
    from trilinos_tpu_torch.precond import SaAmg
    from trilinos_tpu_torch.precond.structured import ClassifiedStencil

    tp = importlib.import_module("trilinos_tpu_torch.ops.stencil_poly")
    dia = importlib.import_module("trilinos_tpu_torch.ops.dia_spmv")
    csrc, build_dir = _build.CSRC, _build.BUILD_DIR

    def use(name):
        """Point `_build` at a variant's sources (None: the shipped
        ones); built at first use."""
        root = build_dir / "variants" / f"v{list(VARIANTS).index(name)}" \
            if name else None
        if root is not None and not (root / "csrc").exists():
            shutil.copytree(csrc, root / "csrc")
            for fname, old, new in VARIANTS[name]:
                f = root / "csrc" / fname
                text = f.read_text()
                if text.count(old) != 1:
                    raise SystemExit(f"FAIL variant {name!r}: {old!r} not "
                                     f"found once in {fname}")
                f.write_text(text.replace(old, new))
        _build.CSRC = root / "csrc" if root else csrc
        _build.BUILD_DIR = root / "build" if root else build_dir
        _build._LIBS.clear()

    def same(got, want):
        return torch.equal(got.view(torch.int32), want.view(torch.int32))

    fine = laplace3d(256, 256, 256, dtype=np.float32, fmt="stencil")
    lmax = ClassifiedStencil.from_constant(fine.offsets,
                                           fine.coeffs).gershgorin()
    cheb3 = stencil_chebyshev_setup(fine, 3, lmax=lmax)
    mono4 = monomial_stages(4, 12.0)
    x0 = randn(fine.n_rows_pad, torch.float32, seed=30)
    want_c = tp.stencil_poly_plain(fine, cheb3, x0)
    want_m = tp.stencil_powers_plain(fine, mono4, x0)

    def poly(label):
        if not (same(tp.stencil_poly_apply(fine, cheb3, x0), want_c) and
                same(tp.stencil_powers_apply(fine, mono4, x0), want_m)):
            raise SystemExit(f"FAIL {label}: not bitwise")
        c = time_ms(lambda: tp.stencil_poly_apply(fine, cheb3, x0))
        m = time_ms(lambda: tp.stencil_powers_apply(fine, mono4, x0))
        log(f"{label}: Chebyshev s=3 u_s {c:.4f} ms, monomial s=4 all "
            f"outputs {m:.4f} ms")

    region, target = dict(tp.REGION), tp.TARGET_BLOCKS
    for wx_wy in REGIONS:
        for tb in TARGETS:
            tp.REGION, tp.TARGET_BLOCKS = {**region, 4: wx_wy}, tb
            tp.stencil_poly_plan.cache_clear()
            plan = tp.stencil_poly_plan(fine, tuple(cheb3), 4)
            poly(f"poly plan: region {wx_wy}, target {tb} blocks (Chebyshev "
                 f"tile {plan.tile}, z-chunk {plan.zc})")
    tp.REGION, tp.TARGET_BLOCKS = region, target
    tp.stencil_poly_plan.cache_clear()

    amg = SaAmg(fine, {"dtype": np.float32}, device="cuda").compute()
    levels = [lv["a"] for lv in amg.levels[1:]]
    xs = [randn((a.n_rows_pad, 16), torch.float32, seed=80 + i)
          for i, a in enumerate(levels)]
    wants = [dia.dia_spmv_plain(a, x) for a, x in zip(levels, xs)]

    def dia_spmm(label):
        times = []
        for a, x, want in zip(levels, xs, wants):
            if not same(dia.dia_spmm(a, x), want):
                raise SystemExit(f"FAIL {label}: not bitwise")
            times.append(f"{time_ms(lambda: dia.dia_spmm(a, x)):.4f}")
        log(f"{label}: DIA SpMM k=16 levels 1-4 {', '.join(times)} ms")

    names = [None, *VARIANTS]
    for name in names + names[::-1]:
        use(name)
        label = name or "shipped"
        if not name or name.startswith("poly"):
            poly(label)
        if not name or name.startswith("dia"):
            dia_spmm(label)
    use(None)
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
