"""The JAX package's counts for the distributed phases of ``chip_smoke.py``
that are held to them, on the CPU in float64 over a 4-device virtual mesh.

    JAX_PLATFORMS=cpu python3 scripts/dist_cpu_counts.py

On ``chip_smoke.DIST_SMALL_DIMS`` (Galeri Laplace3D) with
``chip_smoke.DIST_RANKS`` shards, each through the JAX package's
``dist_solve``:

* config 4 row-partitioned: ``distribute(…, fmt="auto")``, pipelined CG
  with ``dist_jacobi``, rtol 1e-8, the seed-3 right-hand side (the port's
  ``dist_pipelined_cg_entry``);
* CG with the fused Chebyshev smoother ``dist_cheb_fused`` (degree 4,
  λmax ``DIST_CHEB_LMAX``) on the z-slab ``DistStencil``;
* CG with ``dist_amg`` (host set-up) and with ``dist_amg_blocks``
  (distributed set-up) on the stored matrix;
* GMRES(30) with restricted Schwarz ``dist_schwarz`` (overlap 1, ILU(0)
  subdomains, combine ZERO) on config 4's matrix, rtol 1e-8, maxiter
  1000, the seed-3 right-hand side (the port's ``dist_schwarz_entry``);

the cheb_fused and the two AMG cases at ``DIST_RTOL`` on seed-1 normals;
and, for the port's ``dist_md_entry``, ``mdarray.md_solve`` with CG on a
``chip_smoke.DIST_MD_GRID`` mesh (axes x, y, z), the 7-point Laplacian on
1-cell-padded blocks (its terms in the port's stencil order) and the CA
sweep ``md_poly_local`` with degree-3 Chebyshev stages (λmax
``MD_CHEB_LMAX``, λmin = λmax / 30, halo 3), rtol ``MD_RTOL``, on the
seed-0 normals over the global field. Prints one line a case and a JSON
line of the iteration counts at the end; ``chip_smoke.py`` holds its rank
runs to these (``DIST_CPU_ITERS``, ``DIST_MD_CPU_ITERS``). About a minute
on a few cores.
"""
import json
import os
import pathlib
import sys
import time

os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=8")
import numpy as np  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from jax.sharding import Mesh  # noqa: E402

from chip_smoke import (DIST_CHEB_LMAX, DIST_MD_GRID,  # noqa: E402
                        DIST_RANKS, DIST_RTOL, DIST_SMALL_DIMS)
from trilinos_tpu.galeri import laplace3d  # noqa: E402
from trilinos_tpu.parallel import dist_setup  # noqa: E402
from trilinos_tpu.parallel import distmatrix as D  # noqa: E402
from trilinos_tpu.parallel import driver as drv  # noqa: E402
from trilinos_tpu.ops.pallas.stencil_poly import (  # noqa: E402
    chebyshev_stages)
from trilinos_tpu.parallel import mdarray as MD  # noqa: E402
from trilinos_tpu.solvers import cg, cg_pipeline, gmres  # noqa: E402
from trilinos_tpu_torch.entry import MD_CHEB_LMAX, MD_RTOL  # noqa: E402


def lap7(u):
    """7-point Laplacian on a 1-cell-padded block, its terms in the port's
    stencil order (x, the last axis, first)."""
    c = u[1:-1, 1:-1, 1:-1]
    return (6.0 * c
            - u[1:-1, 1:-1, :-2] - u[1:-1, 1:-1, 2:]
            - u[1:-1, :-2, 1:-1] - u[1:-1, 2:, 1:-1]
            - u[:-2, 1:-1, 1:-1] - u[2:, 1:-1, 1:-1])


def main():
    p, dims = DIST_RANKS, DIST_SMALL_DIMS
    mesh = drv.make_mesh(p)
    a = laplace3d(*dims)
    n = a.shape[0]
    counts = {}

    def run(label, solver, dm, b, **kw):
        t0 = time.perf_counter()
        res = drv.dist_solve(solver, dm, jnp.asarray(dm.row_map.to_padded(b)),
                             mesh=mesh, **kw)
        counts[label] = int(res.iters)
        print(f"{label}: {counts[label]} iterations, converged "
              f"{bool(res.converged)}, resnorm {float(res.resnorm):.3e} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)

    dm = D.distribute(a, p, fmt="auto")
    b3 = np.random.default_rng(3).standard_normal(n)
    run("config4", cg_pipeline, dm, b3,
        prec=drv.dist_jacobi(a, dm.row_map), rtol=1e-8)
    b1 = np.random.default_rng(1).standard_normal(n)
    op = laplace3d(*dims, dtype=np.float64, fmt="stencil")
    run("cheb_fused", cg, D.distribute_stencil(op, p), b1,
        prec=drv.dist_cheb_fused(op, p, degree=4, lmax=DIST_CHEB_LMAX),
        rtol=DIST_RTOL, maxiter=500)
    run("amg", cg, dm, b1, prec=drv.dist_amg(a, dm.row_map),
        rtol=DIST_RTOL)
    run("amg_blocks", cg, dm, b1,
        prec=drv.dist_amg_blocks(dist_setup.split_rows(a, dm.row_map),
                                 dm.row_map), rtol=DIST_RTOL)
    run("schwarz", gmres, dm, b3,
        prec=drv.dist_schwarz(a, dm.row_map, overlap=1, combine="ZERO"),
        restart=30, rtol=1e-8, maxiter=1000)
    axes = ("x", "y", "z")
    mesh3 = Mesh(np.array(jax.devices()[:int(np.prod(DIST_MD_GRID))])
                 .reshape(DIST_MD_GRID), axes)
    stages = chebyshev_stages(MD_CHEB_LMAX, MD_CHEB_LMAX / 30.0, 3, 1.0 / 6.0)
    t0 = time.perf_counter()
    res = MD.md_solve(
        cg, MD.MDMap(dims, axes, halo=(1, 1, 1)), mesh3, lap7,
        jnp.asarray(np.random.default_rng(0).standard_normal(dims)),
        prec_local=MD.md_poly_local(MD.MDMap(dims, axes, halo=(3, 3, 3)),
                                    mesh3, lap7, stages),
        rtol=MD_RTOL, maxiter=2000)
    counts["md"] = int(res.iters)
    print(f"md: {counts['md']} iterations, converged {bool(res.converged)}, "
          f"resnorm {float(res.resnorm):.3e} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    print(json.dumps(counts))


if __name__ == "__main__":
    main()
