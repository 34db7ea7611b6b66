"""Time the single-vector stencil SpMV and ``chol_inv_small`` on one NVIDIA
card, this checkout beside an earlier one.

    python3 scripts/sweep_spmv_chol.py [--parent DIR]

Each turn is a process that imports ``trilinos_tpu_torch`` from one
checkout (this one, or the one at DIR) and times its public wrappers by
CUDA-graph replay (``chip_smoke.py`` ``graph_ms``: device time), f32
unless named: ``stencil_spmv`` on Galeri's 7-point cross at 256³, the
same terms in reverse order, the cross with four radius-2 terms, the 2-D
5-point cross and 9-point star on 4096²; ``chol_inv_small`` at k = 16 and
32, f32 and f64; the empty kernel where the checkout has one. In this
checkout's turns it also sweeps the SpMV's plan on the 256³ cross through
the launcher: the z-chunk (1 is one plane a block) and the generic
instance. Turns run parent, this, this, parent (without ``--parent``:
this, this). Prints one line a measurement and the card's name and power
limit, and writes every measurement to chiprun_out/sweep_spmv_chol.json.
Exits non-zero without a CUDA device.
"""
import argparse
import dataclasses
import importlib.util
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
SWEEP_ZC = (1, 2, 4, 8, 16, 32)
GRID3, GRID2 = (256, 256, 256), (4096, 4096)


def turn(root):
    """One checkout's measurements: {label: ms}."""
    import torch

    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from trilinos_tpu_torch.galeri.stencils import (cross2d_stencil,
                                                    cross3d_stencil,
                                                    star2d_stencil)
    from trilinos_tpu_torch.ops import smalldense
    from trilinos_tpu_torch.ops import stencil_op as so

    out = {}

    def timed(label, fn):
        out[label] = smoke.graph_ms(fn)
        print(f"  {label}: {out[label]:.4f} ms", flush=True)

    lap = cross3d_stencil(6.0, *([-1.0] * 6))
    wide = lap + [((-2, 0, 0), 0.25), ((0, 2, 0), -0.125),
                  ((0, 0, -2), 0.5), ((2, 0, 0), 0.0625)]
    stencils = {
        "cross 256^3": (GRID3, lap),
        "cross in reverse order 256^3": (GRID3, lap[::-1]),
        "cross + 4 radius-2 terms 256^3": (GRID3, wide),
        "2-D 5-point cross 4096^2": (GRID2, cross2d_stencil(
            4.0, *([-1.0] * 4))),
        "2-D 9-point star 4096^2": (GRID2, star2d_stencil(
            8.0, *([-1.0] * 8)))}
    for label, (dims, st) in stencils.items():
        op = so.StencilOp.create(dims, st)
        x = smoke.randn(op.n_rows_pad, torch.float32, seed=30)
        timed(f"stencil_spmv {label}", lambda: so.stencil_spmv(op, x))
        if hasattr(so, "spmv_plan") and label == "cross 256^3":
            plan = so.spmv_plan(op, 4, so.pointer_align(x))
            plans = {f"z-chunk {zc}": dataclasses.replace(
                plan, zc=zc, grid=plan.grid[:2] + (-(-256 // zc),))
                for zc in SWEEP_ZC}
            plans["generic instance"] = so.SpmvPlan(
                vw=1, cross=False, block=(64, 4, 1), grid=(4, 64, 256), zc=1)
            for name, p in plans.items():
                def run(p=p):
                    y = torch.empty_like(x)
                    so._call("stencil_spmv_f32", op, x, y, plan=p)
                timed(f"stencil_spmv cross 256^3, plan {name}", run)
        del x
    for dt in (torch.float32, torch.float64):
        for k in (16, 32):
            p = smoke.randn((4096, k), dt, seed=700 + k)
            g = smoke.with_floor(p.T @ p)
            timed(f"chol_inv_small {str(dt)[6:]} k={k}",
                  lambda: smalldense.chol_inv_small(g))
    if hasattr(smalldense, "empty_launch"):
        timed("empty kernel", lambda: smalldense.empty_launch(g.device))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=pathlib.Path, default=None)
    ap.add_argument("--turn", type=pathlib.Path, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn is not None:
        print("RESULT " + json.dumps(turn(args.turn.resolve())), flush=True)
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("sweep_spmv_chol: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    turns = [("this", ROOT), ("this", ROOT)]
    if args.parent is not None:
        turns = [("parent", args.parent)] + turns + [("parent", args.parent)]
    results = {"card": card}
    for name, root in turns:
        print(f"turn: {name} ({root})", flush=True)
        proc = subprocess.run(
            [sys.executable, __file__, "--turn", str(root)],
            capture_output=True, text=True, timeout=900)
        print(proc.stdout, end="", flush=True)
        if proc.returncode:
            sys.exit(f"turn {name} failed:\n{proc.stderr[-4000:]}")
        got = json.loads(proc.stdout.rsplit("RESULT ", 1)[1])
        for label, ms in got.items():
            results.setdefault(name, {}).setdefault(label, []).append(ms)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "sweep_spmv_chol.json").write_text(json.dumps(results, indent=1))
    print(card, flush=True)


if __name__ == "__main__":
    main()
