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
Then the direct-solver phases: every ``chip_smoke.DIRECT_CASES`` name
through ``build`` (GMRES(30) on recirc2d 64², CG on laplace2d 64², rtol
1e-8, maxiter 1000, the matrix stored through ``choose_format``); CG at
rtol 1e-8 on laplace2d 256² with two-level and one-level Schwarz ("add"
combine, 8 × 8 boxes); the Komplex solve of the complex shifted Laplacian
128² with the port's ``KOMPLEX_PARAMS``; and GMRES(40) with block
Gauss-Seidel on the Teko test system. Prints one line a case and a JSON
line of the counts at the end; these are the counts ``chip_smoke.py``
holds its runs against. Minutes on a few cores.
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
from chip_smoke import (BUILD_CASES, BUILD_RTOL, CHOL_NX,  # noqa: E402
                        CONFIG3_NX, DIRECT_CASES, DIRECT_NX, KOMPLEX_NX,
                        KOMPLEX_SHIFT, MAXWELL_DIMS, TL_BOXES, TL_RTOL,
                        box_ids, teko_system)
from trilinos_tpu import precond  # noqa: E402
from trilinos_tpu.galeri import laplace2d, recirc2d  # noqa: E402
from trilinos_tpu.galeri.stencils import maxwell2d  # noqa: E402
from trilinos_tpu.io import read_sparse, write_sparse  # noqa: E402
from trilinos_tpu.ops import (choose_format, csr_to_ell,  # noqa: E402
                              komplex, spmv)
from trilinos_tpu.ops.formats import CsrHost  # noqa: E402
from trilinos_tpu.precond import block_2x2  # noqa: E402
from trilinos_tpu.solvers import (LinearProblem, SolverManager,  # noqa: E402
                                  block_gmres, build, cg, gmres)
from trilinos_tpu_torch.entry import KOMPLEX_PARAMS  # noqa: E402


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


def direct_case(name, solver, matrix):
    a = (recirc2d if matrix == "recirc2d" else laplace2d)(DIRECT_NX,
                                                          DIRECT_NX)
    sp = {"Convergence Tolerance": BUILD_RTOL, "Maximum Iterations": 1000}
    if solver == "GMRES":
        sp["Num Blocks"] = 30
    mgr, prec = build({"Linear Solver Type": solver,
                       "Solver Types": {solver: sp},
                       "Preconditioner Type": name}, a)
    dev = choose_format(a)
    n, npad = a.shape[0], dev.n_rows_pad
    b = np.zeros(npad)
    b[:n] = np.random.default_rng(0).standard_normal(n)
    res = mgr.solve(LinearProblem(lambda x: spmv(dev, x, impl="xla"),
                                  jnp.asarray(b), right_prec=prec))
    true = np.linalg.norm(b[:n] - _csr_mv(a, np.asarray(res.x)[:n])) \
        / np.linalg.norm(b[:n])
    return int(res.iters), bool(np.asarray(res.converged).all()), float(true)


def two_level_cg():
    a = laplace2d(CHOL_NX, CHOL_NX)
    p = {"schwarz: num subdomains": TL_BOXES ** 2,
         "schwarz: subdomain ids": box_ids(CHOL_NX, TL_BOXES),
         "schwarz: combine mode": "add"}
    dev = choose_format(a)
    n, npad = a.shape[0], dev.n_rows_pad
    b = np.zeros(npad)
    b[:n] = np.random.default_rng(0).standard_normal(n)
    two = precond.TwoLevelSchwarz(a, dict(p)).compute()
    out = []
    for m in (two, two.level1):
        res = cg(lambda x: spmv(dev, x, impl="xla"), jnp.asarray(b),
                 prec=m, rtol=TL_RTOL, maxiter=2000)
        out.append(int(res.iters))
    return tuple(out)


def komplex_case():
    lap = laplace2d(KOMPLEX_NX, KOMPLEX_NX)
    n = lap.shape[0]
    idx = np.arange(n)
    rows = np.repeat(np.arange(n), np.diff(lap.row_ptr))
    az = CsrHost.from_coo(np.concatenate([rows, idx]),
                          np.concatenate([lap.cols, idx]),
                          np.concatenate([lap.vals.astype(np.complex128),
                                          np.full(n, 1j * KOMPLEX_SHIFT)]),
                          lap.shape)
    rng = np.random.default_rng(5)
    bz = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    z, res = komplex.solve_complex(az, bz, KOMPLEX_PARAMS)
    rz = np.zeros(n, complex)
    np.add.at(rz, np.repeat(np.arange(n), np.diff(az.row_ptr)),
              az.vals * z[az.cols])
    true = np.linalg.norm(bz - rz) / np.linalg.norm(bz)
    return int(res.iters), bool(res.converged), float(true)


def teko_case():
    (a00, a01, a10, a11), dense, b = teko_system()
    n0 = a00.shape[0]
    m = {k: jnp.asarray(v) for k, v in dict(
        a00=a00, a01=a01, a10=a10, a11=a11, i00=np.linalg.inv(a00),
        i11=np.linalg.inv(a11)).items()}
    blk = block_2x2.BlockedOperator2x2(
        lambda v: m["a00"] @ v, lambda v: m["a01"] @ v,
        lambda v: m["a10"] @ v, lambda v: m["a11"] @ v, n0)
    prec = block_2x2.block_lower_triangular_prec(
        lambda v: m["i00"] @ v, blk.a10, lambda v: m["i11"] @ v, n0)
    res = gmres(blk, jnp.asarray(b), prec=prec, restart=40, rtol=1e-10,
                maxiter=400)
    return int(res.iters)


def main():
    counts = {"config3_block_steps": config3()}
    for label, name, params, _ in BUILD_CASES:
        t0 = time.perf_counter()
        iters, conv, true = build_case(name, params)
        print(f"{label}: GMRES(30) iterations {iters} converged {conv} true "
              f"residual {true:.3e} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
        counts[label] = iters
    for name, solver, matrix, _ in DIRECT_CASES:
        t0 = time.perf_counter()
        iters, conv, true = direct_case(name, solver, matrix)
        print(f"{name}: {solver} on {matrix} {DIRECT_NX}^2 iterations {iters} "
              f"converged {conv} true residual {true:.3e} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        counts[name] = iters
    t0 = time.perf_counter()
    counts["two-level CG"], counts["one-level CG"] = two_level_cg()
    print(f"laplace2d {CHOL_NX}^2 CG: two-level {counts['two-level CG']}, "
          f"one-level {counts['one-level CG']} iterations "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    iters, conv, true = komplex_case()
    print(f"Komplex {KOMPLEX_NX}^2: iterations {iters} converged {conv} true "
          f"residual {true:.3e} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    counts["komplex"] = iters
    counts["teko"] = teko_case()
    print(f"Teko block Gauss-Seidel GMRES(40): {counts['teko']} iterations",
          flush=True)
    print(json.dumps(counts))


if __name__ == "__main__":
    main()
