"""The JAX package's counts for the stored-matrix phases of ``chip_smoke.py``,
on the CPU in float64.

    JAX_PLATFORMS=cpu python3 scripts/stored_path_cpu_counts.py

BASELINE config 3 (Galeri recirc2d 128² through a Matrix Market file, ELL,
Ilu0 with 20 sweeps, DGKS block GMRES on two seed-2 normals, 60 blocks, 20
restarts, rtol 1e-8): block steps and each column's true residual. Then
every case of ``chip_smoke.BUILD_CASES``: the preconditioner through the
JAX package's ``build`` (HIPTMAIR through ``create`` with its discrete
gradient, which ``build`` cannot pass) and GMRES(30) at rtol 1e-8, maxiter
1000, on a seed-0 normal right-hand side: iterations and convergence.
Prints one line a case and a JSON line of the counts at the end; these are
the counts ``chip_smoke.py`` holds its runs against. Minutes on a few
cores.
"""
import json
import pathlib
import sys
import tempfile
import time

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from chip_smoke import (BUILD_CASES, BUILD_RTOL, CONFIG3_NX,  # noqa: E402
                        MAXWELL_DIMS)
from trilinos_tpu import precond  # noqa: E402
from trilinos_tpu.galeri import recirc2d  # noqa: E402
from trilinos_tpu.galeri.stencils import maxwell2d  # noqa: E402
from trilinos_tpu.io import read_sparse, write_sparse  # noqa: E402
from trilinos_tpu.ops import csr_to_ell, spmv  # noqa: E402
from trilinos_tpu.solvers import (LinearProblem, SolverManager,  # noqa: E402
                                  block_gmres, build)


def config3():
    a = recirc2d(CONFIG3_NX, CONFIG3_NX)
    with tempfile.TemporaryDirectory() as tmp:
        path = str(pathlib.Path(tmp) / "recirc2d.mtx")
        write_sparse(path, a)
        a = read_sparse(path)
    dev = csr_to_ell(a)
    n, npad = a.shape[0], dev.n_rows_pad
    b = np.zeros((npad, 2))
    b[:n] = np.random.default_rng(2).standard_normal((n, 2))
    ilu = precond.Ilu0(a, {"fact: sweeps": 20}).compute()
    t0 = time.perf_counter()
    res = block_gmres(lambda x: spmv(dev, x, impl="xla"), jnp.asarray(b),
                      prec=ilu, num_blocks=60, max_restarts=20, rtol=1e-8,
                      ortho="DGKS")
    x = np.asarray(res.x)[:n]
    r = b[:n] - a.to_dense() @ x if n <= 4096 else b[:n] - _csr_mv(a, x)
    true = np.linalg.norm(r, axis=0) / np.linalg.norm(b[:n], axis=0)
    print(f"config 3, recirc2d {CONFIG3_NX}^2: block steps {int(res.iters)} "
          f"converged {np.asarray(res.converged).tolist()} true residuals "
          f"{true.tolist()} ({time.perf_counter() - t0:.1f} s)", flush=True)
    return int(res.iters)


def _csr_mv(a, x):
    rows = np.repeat(np.arange(a.shape[0]), np.diff(a.row_ptr))
    out = np.zeros((a.shape[0],) + x.shape[1:])
    np.add.at(out, rows, a.vals[:, None] * x[a.cols] if x.ndim == 2
              else a.vals * x[a.cols])
    return out


def build_case(name, params):
    if name == "HIPTMAIR":
        nx, ny = MAXWELL_DIMS
        n_e = nx * (ny + 1) + (nx + 1) * ny
        sigma = 10.0 ** np.random.default_rng(9).uniform(-3, 0, n_e)
        a, g = maxwell2d(nx, ny, sigma=sigma)
        mgr = SolverManager("GMRES", {"Num Blocks": 30,
                                      "Convergence Tolerance": BUILD_RTOL,
                                      "Maximum Iterations": 1000})
        prec = precond.create(name, a, dict(params), aux_op=g).compute()
    else:
        a = recirc2d(CONFIG3_NX, CONFIG3_NX)
        mgr, prec = build({
            "Linear Solver Type": "GMRES",
            "Solver Types": {"GMRES": {"Num Blocks": 30,
                                       "Convergence Tolerance": BUILD_RTOL,
                                       "Maximum Iterations": 1000}},
            "Preconditioner Type": name,
            "Preconditioner Types": {name: dict(params)}}, a)
    dev = csr_to_ell(a)
    n, npad = a.shape[0], dev.n_rows_pad
    b = np.zeros(npad)
    b[:n] = np.random.default_rng(0).standard_normal(n)
    res = mgr.solve(LinearProblem(lambda x: spmv(dev, x, impl="xla"),
                                  jnp.asarray(b), right_prec=prec))
    true = np.linalg.norm(b[:n] - _csr_mv(a, np.asarray(res.x)[:n])) \
        / np.linalg.norm(b[:n])
    return int(res.iters), bool(np.asarray(res.converged).all()), float(true)


def main():
    counts = {"config3_block_steps": config3()}
    for label, name, params, _ in BUILD_CASES:
        t0 = time.perf_counter()
        iters, conv, true = build_case(name, params)
        print(f"{label}: GMRES(30) iterations {iters} converged {conv} true "
              f"residual {true:.3e} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
        counts[label] = iters
    print(json.dumps(counts))


if __name__ == "__main__":
    main()
