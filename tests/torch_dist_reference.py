"""The JAX package's side of the port's distributed solve tests, and the
gathering of the port's rank results.

``jax_results(cases)`` runs each named case of ``torch_dist_tasks``
through the JAX package's ``dist_solve`` / ``dist_lsqr`` on a 4-device
virtual CPU mesh; ``port_results(root, cases)`` spawns one gloo group of
4 ranks (``parallel.driver.launch``) that runs the same cases in the port.
Each test file holds a share of the cases, so that the run's workers
compute the shares side by side; ``check_*`` are the files' assertions.
"""
import numpy as np

import jax.numpy as jnp

from trilinos_tpu.galeri import laplace3d as jlaplace3d
from trilinos_tpu.ops import formats as F
from trilinos_tpu.parallel import dist_setup as jds
from trilinos_tpu.parallel import distmatrix as JD
from trilinos_tpu.parallel import driver as jdrv
from trilinos_tpu.solvers import cg as jcg
from trilinos_tpu.solvers import cg_pipeline as jcg_pipeline
from trilinos_tpu.solvers import gmres as jgmres
from trilinos_tpu_torch.parallel import driver as drv
from trilinos_tpu_torch.parallel.map import Map

import torch_dist_tasks as T

P = 4
X_TOL = 1e-8
# LSQR amplifies rounding: the JAX package's own test holds its
# distributed and serial LSQR to 1e-6
LSQR_X_TOL = 1e-6
TIMEOUT = 400.0
JSOLVERS = {"cg": jcg, "gmres": jgmres}


def jcsr(a):
    return F.CsrHost(a.row_ptr, a.cols, a.vals, a.shape)


def _jax_prec(recipe, a, jdm):
    if recipe is None:
        return None
    kind, kw = recipe
    rmap = jdm.row_map
    if kind == "ilu0":
        return jdrv.dist_ilu0(a, rmap)
    if kind == "chebyshev":
        return jdrv.dist_chebyshev(a, rmap, **kw)
    if kind == "amg":
        return jdrv.dist_amg(a, rmap, **kw)
    return jdrv.dist_amg_blocks(jds.split_rows(a, rmap), rmap, **kw)


def _jax_case(name, mesh):
    """(host x, iterations, right-hand side or None) of case ``name``."""
    b = None
    if name in T.solve_problems():
        a, solver, kw, recipe = T.solve_problems()[name]
        ja = jcsr(a)
        dm = JD.distribute(ja, P)
        bg = jnp.asarray(dm.row_map.to_padded(T.vectors(a.shape[0], 1)))
        res = jdrv.dist_solve(JSOLVERS[solver], dm, bg, mesh=mesh,
                              prec=_jax_prec(recipe, ja, dm), **kw)
    elif name in T.STENCIL_CASES:
        dims, _, kw = T.STENCIL_CASES[name]
        op = jlaplace3d(*dims, dtype=np.float64, fmt="stencil")
        dm = JD.distribute_stencil(op, P)
        bg = jnp.asarray(dm.row_map.to_padded(T.vectors(op.n_rows, 1)))
        res = jdrv.dist_solve(jcg, dm, bg, mesh=mesh,
                              prec=jdrv.dist_cheb_fused(op, P, degree=4),
                              **kw)
    elif name == "lsqr":
        dm = JD.distribute(jcsr(T.nonsym_csr(2, T.LSQR_N)), P)
        bg = jnp.asarray(dm.row_map.to_padded(T.vectors(T.LSQR_N, 1)))
        res = jdrv.dist_lsqr(dm, bg, mesh=mesh, **T.LSQR_KW)
    elif name == "entry/pipelined_cg":
        # config 4 row-partitioned: DIA interiors, pipelined CG + jacobi
        ja = jlaplace3d(*T.ENTRY_DIMS["pipelined_cg"])
        dm = JD.distribute(ja, P, fmt="auto")
        b = np.random.default_rng(3).standard_normal(ja.shape[0])
        res = jdrv.dist_solve(jcg_pipeline, dm,
                              jnp.asarray(dm.row_map.to_padded(b)),
                              mesh=mesh,
                              prec=jdrv.dist_jacobi(ja, dm.row_map),
                              rtol=1e-8)
    else:
        # structured AMG-PCG on the z-slab stencil, entry()'s settings
        op = jlaplace3d(*T.ENTRY_DIMS["amg"], dtype=np.float64,
                        fmt="stencil")
        dm = JD.distribute_stencil(op, P)
        b = np.random.default_rng(0).standard_normal(op.n_rows)
        res = jdrv.dist_solve(jcg, dm, jnp.asarray(dm.row_map.to_padded(b)),
                              mesh=mesh,
                              prec=jdrv.dist_amg_structured(
                                  op, P, dtype=np.float64),
                              rtol=1e-5, maxiter=50)
    return dict(x=dm.row_map.from_padded(np.asarray(res.x)),
                iters=int(res.iters), b=b)


def jax_results(cases):
    mesh = jdrv.make_mesh(P)
    return {name: _jax_case(name, mesh) for name in cases}


def port_results(root, cases):
    """Each case's rank parts: the padded x and right-hand side in rank
    order, every rank's iterations and convergence."""
    ranks = drv.launch(T.ranks_solve, P, list(cases), device="cpu",
                       rendezvous_dir=root, timeout=TIMEOUT)
    out = {}
    for name in cases:
        parts = [r[name] for r in ranks]
        out[name] = dict(xp=np.concatenate([q["x"] for q in parts]),
                         iters=[q["iters"] for q in parts],
                         converged=[q["converged"] for q in parts])
        if "b" in parts[0]:
            out[name]["bp"] = np.concatenate([q["b"] for q in parts])
    return out


def row_map(name):
    """The row map of case ``name`` (both packages build the same one)."""
    if name in T.solve_problems():
        n = T.solve_problems()[name][0].shape[0]
    elif name in T.STENCIL_CASES:
        n = int(np.prod(T.STENCIL_CASES[name][0]))
    elif name == "lsqr":
        n = T.LSQR_N
    else:
        n = int(np.prod(T.ENTRY_DIMS[name.split("/")[1]]))
    return Map.uniform(n, P)


def check_iterations(port, ref, case):
    its = port[case]["iters"]
    assert len(set(its)) == 1, its  # every rank ran the same iterations
    assert its[0] == ref[case]["iters"]
    assert all(port[case]["converged"])


def check_solution(port, ref, case):
    x = row_map(case).from_padded(port[case]["xp"])
    want = ref[case]["x"]
    err = np.abs(x - want).max() / np.abs(want).max()
    assert err <= (LSQR_X_TOL if case == "lsqr" else X_TOL), err
