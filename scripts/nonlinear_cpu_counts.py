"""The CPU counts that ``chip_smoke.py`` holds its application-layer phase
to: the JAX package's and the port's, side by side.

    JAX_PLATFORMS=cpu python3 scripts/nonlinear_cpu_counts.py

* ``examples/nonlinear_pde.py``'s composition (steady Newton at λ = 1,
  pseudo-arclength continuation toward the fold, the adaptive implicit
  march) on Galeri Laplace2D 24² as DIA in float32 and in float64,
  through the JAX package's ``nonlinear`` (arrays of that dtype
  throughout) and through the port's ``nonlinear_pde_entry`` on the CPU:
  Newton iterations and inner
  GMRES iterations, continuation points, rejected steps and corrector
  Newton iterations, march steps, rejections and Newton iterations.
* ``lbfgs`` on the ROL zoo's Rosenbrock from (-1.2, 1, ...) at n = 2²⁰ in
  float64 (``LBFGS_N``): iterations and line-search evaluations, both
  packages.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from trilinos_tpu import optim as jopt  # noqa: E402
from trilinos_tpu.galeri import laplace2d as j_laplace2d  # noqa: E402
from trilinos_tpu.nonlinear import (continuation, integrate_adaptive,  # noqa
                                    newton_krylov)
from trilinos_tpu.ops import formats as jF  # noqa: E402
from trilinos_tpu.ops import matvec as jS  # noqa: E402
from trilinos_tpu_torch.entry import nonlinear_pde_entry  # noqa: E402
from trilinos_tpu_torch.optim import lbfgs  # noqa: E402

NX = 24
LBFGS_N = 2 ** 20


def jax_nonlinear_pde(nx=NX, dtype=np.float32):
    a = j_laplace2d(nx, nx, dtype=dtype)
    dev = jF.csr_to_dia(a)
    n, npad = a.shape[0], dev.n_rows_pad
    h2 = dtype(1.0 / (nx + 1) ** 2)
    mask = np.zeros(npad, dtype)
    mask[:n] = 1.0
    mj = jnp.asarray(mask)

    def residual(u, lam):
        return mj * (jS.spmv(dev, u, impl="xla") - h2 * lam * jnp.exp(u) * mj)

    u0 = jnp.zeros(npad, dtype)
    res = newton_krylov(lambda u: residual(u, dtype(1.0)), u0,
                        rtol=0.0, atol=3e-6)
    path = continuation(residual, res.x, p0=1.0, p_final=6.5, dp0=0.5,
                        arclength=True, max_steps=40, newton_rtol=0.0,
                        newton_atol=1e-5)
    rhs = lambda t, u: mj * (1.0 * jnp.exp(u) * mj  # noqa: E731
                             - jS.spmv(dev, u, impl="xla") / h2)
    tr = integrate_adaptive(rhs, u0, 0.0, 1.0, 0.02, order=2, rtol=1e-5,
                            newton_atol=1e-5)
    return {"newton_iters": int(res.iters),
            "newton_inner": int(res.inner_iters),
            "cont_points": len(path.params),
            "cont_failed": path.steps_failed,
            "cont_max_lambda": float(path.params.max()),
            "march_steps": tr.steps, "march_rejected": tr.rejected,
            "march_newton": tr.newton_iters}


def rosen_counts(n=LBFGS_N):
    x0 = np.tile([-1.2, 1.0], n // 2)
    jr = jopt.lbfgs(lambda x: jnp.sum(100.0 * (x[1::2] - x[::2] ** 2) ** 2
                                      + (1.0 - x[::2]) ** 2),
                    jnp.asarray(x0), gtol=1e-6, maxiter=500)
    tr = lbfgs(lambda x: torch.sum(100.0 * (x[1::2] - x[::2] ** 2) ** 2
                                   + (1.0 - x[::2]) ** 2),
               torch.from_numpy(x0), gtol=1e-6, maxiter=500)
    return ({"iters": jr.iters, "evals": jr.inner_iters},
            {"iters": tr.iters, "evals": tr.inner_iters})


if __name__ == "__main__":
    torch.set_num_threads(4)
    keys = ("newton_iters", "newton_inner", "cont_points", "cont_failed",
            "cont_newton", "cont_max_lambda", "march_steps",
            "march_rejected", "march_newton")
    for dt in (np.float32, np.float64):
        name = np.dtype(dt).name
        print(f"nonlinear_pde {name}, JAX package:", jax_nonlinear_pde(
            dtype=dt))
        port = nonlinear_pde_entry(NX, dtype=dt, device="cpu")
        print(f"nonlinear_pde {name}, port:", {k: port[k] for k in keys})
    j, t = rosen_counts()
    print(f"lbfgs Rosenbrock n={LBFGS_N} f64: JAX package {j}, port {t}")
