"""The JAX package's counts for the eigensolver phases of ``chip_smoke.py``,
on the CPU in float64.

    JAX_PLATFORMS=cpu python3 scripts/eigen_cpu_counts.py

Every solve goes through the JAX package's Anasazi factory on its
matrix-free Galeri Laplace3D stencil, from the start block the port's
``eigen_entry`` builds (``default_rng(7)`` normals, zero pad rows, the
kind's own width), with ``chip_smoke.EIG_NEV`` pairs:

* Block Krylov-Schur LM, block size 2, rtol 1e-8, 20 restarts, on the
  grids 8³ … 16³: converged or not and total steps (the largest converged
  grid is ``chip_smoke.BKS_CONV_DIMS``);
* every ``chip_smoke.EIG_SMALL_CASES`` kind on ``EIG_SMALL_DIMS``:
  iterations, converged and eigenvalues;
* Generalized Davidson LM on recirc2d ``CONFIG3_NX``² (ELL) at a fixed
  ``EIG_GD_ITERS`` iterations: its Ritz values;
* Block Davidson SR on the pencil K x = λ M x, M the tensor Q1 mass
  stencil, on ``EIG_SMALL_DIMS``, preconditioned by the structured AMG
  V-cycle of K (the JAX package's SaAmg, f64);
* ``eigs_near`` (shift-invert Lanczos, inner MINRES) at the shift
  λ₁ + 0.3(λ₂ − λ₁) on ``EIG_SMALL_DIMS``.

Prints one line a case and a JSON line of the counts at the end; these are
the counts ``chip_smoke.py`` prints its runs beside. A few minutes on a
few cores.
"""
import json
import pathlib
import sys
import time

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from chip_smoke import (CONFIG3_NX, EIG_GD_ITERS, EIG_NEV,  # noqa: E402
                        EIG_SMALL_CASES, EIG_SMALL_DIMS, closed_form,
                        mass27_stencil)
from trilinos_tpu.eigen import (EigenProblem, create_eigensolver,  # noqa: E402
                                eigs_near)
from trilinos_tpu.galeri import laplace3d, recirc2d  # noqa: E402
from trilinos_tpu.ops import csr_to_ell, spmv  # noqa: E402
from trilinos_tpu.ops.pallas.stencil_op import StencilOp  # noqa: E402
from trilinos_tpu.precond import SaAmg  # noqa: E402
from trilinos_tpu_torch.entry import eigen_entry  # noqa: E402


def solve(name, params, dims, mass=None, amg=False):
    """The JAX factory's solve from eigen_entry's start block, with the
    structured AMG V-cycle of the stencil as ``prec`` when ``amg``."""
    op = laplace3d(*dims, fmt="stencil")
    prec = None
    if amg:
        h = SaAmg(op, {"dtype": np.float64}).compute()
        st = h.state()
        prec = lambda v: h.apply_state(st, v)  # noqa: E731
    _, (v0, _) = eigen_entry(name, params, dims=dims, nev=EIG_NEV,
                             device="cpu")
    m = None
    if mass is not None:
        mop = StencilOp.create(dims, mass, dtype="float64")
        m = lambda v: spmv(mop, v)  # noqa: E731
    t0 = time.perf_counter()
    res = create_eigensolver(name, params).solve(EigenProblem(
        op=lambda v: spmv(op, v), n=op.n_rows_pad, nev=EIG_NEV,
        v0=v0.numpy(), m=m, prec=prec))
    return res, time.perf_counter() - t0


def main():
    out = {}
    bks = {"Which": "LM", "Block Size": 2}
    for n in (8, 10, 12, 14, 16):
        res, secs = solve("Block Krylov Schur", bks, (n,) * 3)
        print(f"BKS LM {n}^3: converged {res.converged} steps {res.iters} "
              f"eigenvalues {res.eigenvalues} ({secs:.1f} s)", flush=True)
        out[f"bks_{n}"] = [bool(res.converged), int(res.iters)]
    for name, params in EIG_SMALL_CASES:
        res, secs = solve(name, params, EIG_SMALL_DIMS)
        if isinstance(res, tuple):  # LANCZOS, POWER
            vals = np.atleast_1d(np.asarray(res[0]))
            iters = int(res[2]) if name == "POWER" else params["Num Blocks"]
            conv = None
        else:
            vals, iters, conv = (np.asarray(res.eigenvalues), int(res.iters),
                                 bool(res.converged))
        print(f"{name} {EIG_SMALL_DIMS}: iterations {iters} converged {conv} "
              f"values {vals!r} ({secs:.1f} s)", flush=True)
        out[name] = [iters, conv, vals.tolist()]
    a = recirc2d(CONFIG3_NX, CONFIG3_NX)
    ell = csr_to_ell(a)
    v0 = np.zeros((ell.n_rows_pad, EIG_NEV))
    v0[:a.shape[0]] = np.random.default_rng(7).standard_normal(
        (a.shape[0], EIG_NEV))
    t0 = time.perf_counter()
    res = create_eigensolver("Generalized Davidson", {
        "Which": "LM", "Maximum Iterations": EIG_GD_ITERS}).solve(
        EigenProblem(op=lambda v: spmv(ell, v), n=ell.n_rows_pad,
                     nev=EIG_NEV, symmetric=False, v0=v0))
    print(f"Generalized Davidson recirc2d {CONFIG3_NX}^2 LM: iterations "
          f"{res.iters} converged {res.converged} values {res.eigenvalues} "
          f"residuals {res.resnorms} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    out["Generalized Davidson"] = [int(res.iters), bool(res.converged),
                                   [[v.real, v.imag] for v in
                                    np.asarray(res.eigenvalues)]]
    res, secs = solve("Block Davidson", {"Which": "SR"}, EIG_SMALL_DIMS,
                      mass=mass27_stencil(), amg=True)
    want = closed_form(EIG_SMALL_DIMS, EIG_NEV, mass=True)
    print(f"Block Davidson SR + AMG, Q1 mass pencil {EIG_SMALL_DIMS}: "
          f"iterations {res.iters} converged {res.converged} values {res.eigenvalues} "
          f"(closed form {want}) ({secs:.1f} s)", flush=True)
    out["Block Davidson mass"] = [int(res.iters), bool(res.converged),
                                  np.asarray(res.eigenvalues).tolist()]
    lam = closed_form(EIG_SMALL_DIMS, 2)
    sigma = lam[0] + 0.3 * (lam[1] - lam[0])
    op = laplace3d(*EIG_SMALL_DIMS, fmt="stencil")
    v = np.zeros(op.n_rows_pad)
    v[:op.n_rows] = np.random.default_rng(7).standard_normal(op.n_rows)
    t0 = time.perf_counter()
    got, _ = eigs_near(lambda x: spmv(op, x), sigma, 2, jnp.asarray(v))
    print(f"eigs_near sigma {sigma!r} {EIG_SMALL_DIMS}: {np.asarray(got)} "
          f"(closed form {lam}) ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    out["eigs_near"] = np.asarray(got).tolist()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
