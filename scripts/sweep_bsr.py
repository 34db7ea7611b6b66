"""Time formulations of the BSR SpMM of BASELINE config 2 on one NVIDIA card.

    python3 scripts/sweep_bsr.py

Galeri Laplace3D 64³ packed as BSR with b = 4 (7 blocks a block row) on
nrhs = 4 columns, f64 and f32. Each formulation computes y[r] = Σ_s
bvals[r, s] · x[bcols[r, s]] from the same gathered panels, is checked
against the f64 sparse CSR product of the host matrix and timed by
CUDA-graph replay (``chip_smoke.py`` ``graph_ms``: device time):

* ``matmul_sum``: one batched b×b matmul per block, then the sum over a
  block row's blocks (the (nbr, kb) batch is nbr·kb tiny GEMMs);
* ``einsum``: ``torch.einsum("rkij,rkjn->rin")``;
* ``row_bmm``: one (b × kb·b)·(kb·b × nrhs) matmul per block row, the
  blocks laid out (nbr, b, kb·b) once beforehand;
* ``mul_sum``: elementwise products and one sum, no GEMM;
* ``gather``: the panel gather alone; ``port``: the port's ``bsr_spmm``.

Prints one line a measurement and the card's name and power limit, and
writes them to chiprun_out/sweep_bsr.json. Exits non-zero without a CUDA
device.
"""
import importlib.util
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
DIMS, B, NRHS = (64, 64, 64), 4, 4


def main():
    if not torch.cuda.is_available():
        print("sweep_bsr: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location("smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from trilinos_tpu_torch.galeri import laplace3d
    from trilinos_tpu_torch.ops import bsr_spmm, csr_to_bsr

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    h = laplace3d(*DIMS)
    csr = torch.sparse_csr_tensor(
        torch.from_numpy(h.row_ptr), torch.from_numpy(h.cols.astype(np.int64)),
        torch.from_numpy(h.vals), h.shape).to("cuda")
    out = {"card": card}
    for dt in (torch.float64, torch.float32):
        a = csr_to_bsr(h, B, dtype=dt, device="cuda")
        nbr, kb = a.bcols.shape
        x = torch.randn((a.n_rows_pad, NRHS), device="cuda", dtype=dt)
        want = csr @ x.double()
        rows = a.bvals.permute(0, 2, 1, 3).reshape(nbr, B, kb * B)
        rows = rows.contiguous()

        def panels():
            return x.reshape(-1, B, NRHS)[a.bcols]

        forms = {
            "matmul_sum": lambda: torch.matmul(a.bvals, panels()).sum(1),
            "einsum": lambda: torch.einsum("rkij,rkjn->rin", a.bvals,
                                           panels()),
            "row_bmm": lambda: torch.bmm(rows, panels().reshape(
                nbr, kb * B, NRHS)),
            "mul_sum": lambda: (a.bvals[..., None] * panels()[:, :, None])
            .sum(dim=(1, 3)),
            "gather": panels,
            "port": lambda: bsr_spmm(a, x)}
        for name, fn in forms.items():
            if name != "gather":
                got = fn().reshape(-1, NRHS).double()
                err = float((got - want).abs().max() / want.abs().max())
            else:
                err = 0.0
            ms = smoke.graph_ms(fn)
            label = f"{name} {str(dt)[6:]}"
            out[label] = {"ms": ms, "max_rel_err": err}
            print(f"{label}: {ms:.4f} ms (max rel err vs CSR f64 "
                  f"{err:.2e})", flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "sweep_bsr.json").write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
