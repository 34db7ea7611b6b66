"""The application phase of ``chip_smoke.py`` (section 7z) alone, on one
CUDA card.

    python3 scripts/chip_application.py

Runs ``chip_smoke.application_only``: the kernels built, the 256³ f32
Laplace3D stencil with its Jacobi SA-AMG hierarchy and the elasticity BDIA
matrix on ``EL_DIMS`` nodes, then ``application_phase`` with every gate,
between two prints of the card's name and power limit. It times the phase
and its set-up apart from the rest of the smoke run; run ``chip_smoke.py``
for the kernels line.
"""
import pathlib
import subprocess
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("chip_application: no CUDA device", file=sys.stderr)
        sys.exit(2)
    t0 = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cs.log(card)
    cs.application_only()
    cs.log(f"chip_application total: {time.perf_counter() - t0:.1f} s")
    cs.log(card)


if __name__ == "__main__":
    main()
