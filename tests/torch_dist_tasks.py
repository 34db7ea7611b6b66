"""Rank bodies of the port's distributed tests, and the problems they share
with the JAX package's side.

The rank processes start in this module (``parallel.driver.launch`` spawns
them and they import the rank function by name), so it imports only the
port and numpy — never JAX. Each function runs in every rank of a gloo
group on the CPU and returns plain data (its local vectors, iteration
counts); the test files gather the ranks' parts and hold them against the
JAX package's distributed results.

``shared`` lets the xdist workers of one run compute a module's results
once: the first worker computes and stores them, the others read them.
"""
from __future__ import annotations

import fcntl
import os
import pickle
import traceback

import numpy as np
import torch
import torch.distributed as dist

from trilinos_tpu_torch import eigen as E
from trilinos_tpu_torch.entry import (dist_amg_entry, dist_eigen_entry,
                                      dist_md_entry,
                                      dist_pipelined_cg_entry,
                                      dist_schwarz_entry, dist_sstep_entry,
                                      dryrun_rank, eigen_entry, sstep_entry)
from trilinos_tpu_torch.galeri import laplace2d, laplace3d, recirc2d
from trilinos_tpu_torch.io import read_sparse_distributed
from trilinos_tpu_torch.ops.formats import CsrHost
from trilinos_tpu_torch.ops.matvec import spmv
from trilinos_tpu_torch.parallel import dist_setup
from trilinos_tpu_torch.parallel import distmatrix as D
from trilinos_tpu_torch.parallel import driver as drv
from trilinos_tpu_torch.parallel import mdarray as MD
from trilinos_tpu_torch.parallel.comm import ProcessGrid
from trilinos_tpu_torch.parallel.map import Map
from trilinos_tpu_torch.precond import SaAmg
from trilinos_tpu_torch.solvers import (cg, cg_single_reduce,
                                        dist_dense_solve, gmres)
from trilinos_tpu_torch.ops.stencil_poly import chebyshev_stages
from trilinos_tpu_torch.solvers.sstep_gmres import estimate_opnorm

K = 4  # multivector width of the SpMV cases
COMBINE_SCALES = {"ADD": 1.0, "INSERT": 3.0, "REPLACE": 3.0,
                  "ABSMAX": -2.0, "ZERO": 1.0}


def shared(name: str, compute, tmp_path_factory):
    """``compute()`` once for every xdist worker of this run: the first
    caller computes under a file lock and stores the result (or its
    error); the rest read it."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    path = root / f"{name}.pkl"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            status, value = pickle.loads(path.read_bytes())
        else:
            try:
                status, value = "ok", compute()
            except Exception:
                status, value = "error", traceback.format_exc()
            path.write_bytes(pickle.dumps((status, value)))
    if status != "ok":
        raise RuntimeError(f"{name} failed:\n{value}")
    return value


def nonsym_csr(seed: int, n: int, density: float = 0.04) -> CsrHost:
    """Diagonally dominant, structurally nonsymmetric random matrix (the
    JAX package's ``test_dist_transpose`` generator)."""
    rng = np.random.default_rng(seed)
    nnz = max(int(n * n * density), n)
    rows = rng.integers(0, n, nnz)
    cols = rng.integers(0, n, nnz)
    vals = rng.standard_normal(nnz)
    d = np.arange(n)
    return CsrHost.from_coo(
        np.concatenate([rows, d]), np.concatenate([cols, d]),
        np.concatenate([vals, 8.0 * np.ones(n)]), (n, n))


def vectors(n: int, seed: int, k: int | None = None) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (n,) if k is None else (n, k))


def _local(rmap, x: np.ndarray, rank: int, device) -> torch.Tensor:
    return torch.from_numpy(
        rmap.local_chunk(rmap.to_padded(x), rank).copy()).to(device)


# -- SpMV, transpose and the combine modes -----------------------------------

def spmv_problems():
    """name → host matrix of the SpMV cases."""
    return {"laplace2d": laplace2d(12, 11), "nonsym": nonsym_csr(3, 96)}


def ranks_spmv(comm, device, mtx_path=None):
    """Every rank's local parts of A·x and Aᵀ·x (1-D and k = 4) on each
    SpMV problem, of the combine-mode exports and of a distributed read."""
    me, p = comm.index(), comm.size
    out = {"staged": 0}
    for name, a in spmv_problems().items():
        dm = D.distribute(a, p)
        al = dm.local(me, device)
        n = a.shape[0]
        for label, x in (("1d", vectors(n, 5)), ("k4", vectors(n, 6, K))):
            xl = _local(dm.row_map, x, me, device)
            out[f"{name}/spmv/{label}"] = drv.dist_spmv(al, xl, comm)
            out[f"{name}/spmv_t/{label}"] = drv.dist_spmv_t(al, xl, comm)
        out[f"{name}/mode"] = al.plan.mode
    a = laplace2d(12, 11)
    dm = D.distribute(a, p)
    al = dm.local(me, device)
    xl = _local(dm.row_map, vectors(a.shape[0], 7), me, device)
    ghosts = D.exchange(xl, al.plan, comm)
    for mode, scale in COMBINE_SCALES.items():
        out[f"combine/{mode}"] = D.export_combine(xl, ghosts * scale,
                                                  al.plan, comm, mode)
    out.update(schwarz_applies(comm, device))
    # LOBPCG over the group (the JAX package runs it at 4 and 8 shards)
    out["eigen/lobpcg"] = _eigen("lobpcg", comm, device)
    # the twins of the JAX package's two-level mesh, mdarray and Pliris
    # tests on 8 ranks; on 4, the md entry on a (2, 2, 1) grid and the
    # dryrun's rank body (every solver and eigensolver kind first)
    out["twins"] = ({"grid": grid_cases(comm, device),
                     "md": md_cases(comm, device),
                     "pliris": pliris_cases(comm, device)} if p == 8
                    else {"md_entry": md_entry_case(comm, device),
                          "dryrun": dryrun_rank(comm, device)})
    if mtx_path is not None:
        dmr = read_sparse_distributed(mtx_path, p)
        alr = dmr.local(me, device)
        xr = _local(dmr.row_map, vectors(dmr.row_map.n_global, 8), me,
                    device)
        out["read/spmv"] = drv.dist_spmv(alr, xr, comm)
        out["read/mode"] = alr.plan.mode
    out["staged"] = comm.staged_bytes
    return out


def ranks_mismatch(comm, device):
    """A deliberately mismatched pair of collectives: rank 0 enters an
    all_reduce, rank 1 waits for a message rank 0 never sends."""
    if comm.index() == 0:
        comm.psum(torch.ones(1))
    else:
        dist.recv(torch.zeros(1), src=0)
    return "unreachable"


# -- distributed solves -------------------------------------------------------

def solve_problems():
    """name → (host matrix, solver name, keywords, preconditioner recipe)
    of the solve cases; the recipe names the JAX and port constructors'
    shared arguments."""
    return {
        "cg": (laplace2d(20, 20), "cg", dict(rtol=1e-10), None),
        "gmres_ilu0": (recirc2d(16, 16), "gmres",
                       dict(restart=40, rtol=1e-8), ("ilu0", {})),
        "cg_chebyshev": (laplace2d(16, 16), "cg", dict(rtol=1e-9),
                         ("chebyshev", dict(lmax=1.9, degree=4))),
        "cg_amg": (laplace3d(12, 12, 8), "cg", dict(rtol=1e-8),
                   ("amg", dict(coarse_max=32))),
        "cg_amg_blocks": (laplace3d(12, 12, 8), "cg", dict(rtol=1e-8),
                          ("amg_blocks", dict(coarse_max=32))),
    }


# pipelined CG with jacobi and CG with amg_structured are the entries' cases
STENCIL_CASES = {
    # name → (dims, preconditioner, keywords of the solve)
    "cg_cheb_fused": ((8, 8, 32), "cheb_fused",
                      dict(rtol=1e-10, maxiter=500)),
}
SOLVERS = {"cg": cg, "gmres": gmres}
LSQR_N, LSQR_KW = 160, dict(rtol=1e-10, maxiter=800)
ENTRY_DIMS = {"pipelined_cg": (8, 8, 8), "amg": (16, 16, 16)}


def _port_prec(recipe, a, dm):
    if recipe is None:
        return None
    kind, kw = recipe
    rmap = dm.row_map
    if kind == "ilu0":
        return drv.dist_ilu0(a, rmap)
    if kind == "chebyshev":
        return drv.dist_chebyshev(a, rmap, **kw)
    if kind == "amg":
        return drv.dist_amg(a, rmap, **kw)
    return drv.dist_amg_blocks(dist_setup.split_rows(a, rmap), rmap, **kw)


def _solve_case(name, comm, device):
    """This rank's result of solve case ``name``: its local x, the
    iteration count, the residual norm and convergence (and the entries'
    right-hand side)."""
    me, p = comm.index(), comm.size
    b_out = None
    if name in solve_problems():
        a, solver, kw, recipe = solve_problems()[name]
        dm = D.distribute(a, p)
        b = _local(dm.row_map, vectors(a.shape[0], 1), me, device)
        res = drv.dist_solve(SOLVERS[solver], dm, b, comm=comm,
                             prec=_port_prec(recipe, a, dm), **kw)
    elif name in STENCIL_CASES:
        dims, _, kw = STENCIL_CASES[name]
        op = laplace3d(*dims, dtype=np.float64, fmt="stencil")
        ds = D.distribute_stencil(op, p)
        prec = drv.dist_cheb_fused(op, p, degree=4, device=device)
        b = _local(ds.row_map, vectors(op.n_rows, 1), me, device)
        res = drv.dist_solve(cg, ds, b, comm=comm, prec=prec, **kw)
    elif name == "lsqr":
        dm = D.distribute(nonsym_csr(2, LSQR_N), p)
        b = _local(dm.row_map, vectors(LSQR_N, 1), me, device)
        res = drv.dist_lsqr(dm, b, comm=comm, **LSQR_KW)
    elif name == "entry/pipelined_cg":
        step, (b_out,) = dist_pipelined_cg_entry(
            ENTRY_DIMS["pipelined_cg"], n_ranks=p, comm=comm, device=device)
        res = step(b_out)
    else:
        step, (b_out,) = dist_amg_entry(ENTRY_DIMS["amg"], n_ranks=p,
                                        comm=comm, dtype=np.float64,
                                        device=device)
        res = step(b_out)
    out = dict(x=res.x, iters=int(res.iters), resnorm=float(res.resnorm),
               converged=bool(res.converged))
    if b_out is not None:
        out["b"] = b_out
    return out


def ranks_solve(comm, device, cases):
    """Every rank's result of each named case: the solve cases above and
    the Schwarz, s-step, eigensolver and entry cases below."""
    return {name: (RANK_CASES[name](comm, device) if name in RANK_CASES
                   else _solve_case(name, comm, device))
            for name in cases}


def ranks_fail_one(comm, device):
    """Rank 1 raises before a reduction that rank 0 then waits in."""
    if comm.index() == 1:
        raise ValueError("rank body failed on purpose")
    comm.psum(torch.ones(1))
    return "unreachable"


# -- Schwarz, s-step GMRES, eigensolves and their entries --------------------

SCHWARZ_MODES = ("ZERO", "ADD")
# the JAX package's twin (tests/test_dist_precond.py TestDistSchwarz)
SCHWARZ_DIMS = (10, 10, 8)
# dist_sstep_gmres on the JAX package's twin grids and settings
# (tests/test_dist_stencil.py TestDistSstepGmres, tests/test_krylov.py
# test_dist_sstep_bf16); Newton shifts with one conjugate pair (a
# quadratic stage, γ ≠ 0), Leja-ordered
SSTEP_DIMS = (16, 16, 16)
SSTEP_KW = dict(s=3, t_blocks=5, max_restarts=25, rtol=1e-5)
SSTEP_NEWTON_SHIFTS = (11.0, 5.0 + 3.0j, 5.0 - 3.0j)
SSTEP_NEWTON_KW = dict(s=3, t_blocks=5, max_restarts=40, rtol=1e-8)
SSTEP_BF16_DIMS = (16, 8, 32)
SSTEP_BF16_KW = dict(s=2, t_blocks=4, max_restarts=100, rtol=1e-4)
# the eigensolver twins (tests/test_dist_eigen.py): name → (grid of
# laplace2d, nev, solver, keywords); "davidson" takes dist_jacobi
EIGEN_CASES = {
    "lobpcg": ((12, 10), 4, "lobpcg", dict(which="SM", tol=1e-9,
                                            maxiter=300)),
    "lobpcg_v0": ((10, 10), 3, "lobpcg", dict(which="SM", tol=1e-9,
                                               maxiter=200)),
    "bks": ((12, 10), 4, "block_krylov_schur",
            dict(which="LM", symmetric=True, tol=1e-9)),
    "tracemin": ((10, 8), 3, "tracemin", dict(tol=1e-8, maxiter=200)),
    "davidson": ((12, 8), 3, "block_davidson",
                 dict(which="SA", tol=1e-8, maxiter=150)),
    "rtr": ((10, 8), 3, "rtr", dict(tol=1e-8, maxiter=150)),
    # 12 rows a rank, fewer than the basis limit of 18: the limit must be
    # read from the global row count
    "generalized_davidson": ((8, 6), 3, "generalized_davidson",
                             dict(which="LM", tol=1e-8, maxiter=300)),
}
GLOBAL_OP_GRID = (16, 8)
ENTRY_SMALL = {"sstep": (16, 16, 16), "eigen": (16, 16, 16),
               "schwarz": SCHWARZ_DIMS}


def lobpcg_v0(n):
    return np.random.default_rng(3).standard_normal((n, 3))


def schwarz_applies(comm, device):
    """The Schwarz applies (ZERO and ADD, 1-D and k = 4) on this rank's
    rows."""
    me, p = comm.index(), comm.size
    a = laplace3d(*SCHWARZ_DIMS)
    dm = D.distribute(a, p)
    n = a.shape[0]
    out = {}
    for mode in SCHWARZ_MODES:
        m = drv.global_precond(drv.dist_schwarz(a, dm.row_map, overlap=1,
                                                combine=mode), dm, comm,
                               device)
        for label, x in (("1d", vectors(n, 9)), ("k4", vectors(n, 10, K))):
            out[f"schwarz/{mode}/{label}"] = m(_local(dm.row_map, x, me,
                                                      device))
    return out


def _eigen(name, comm, device):
    grid, nev, solver, kw = EIGEN_CASES[name]
    a = laplace2d(*grid)
    dm = D.distribute(a, comm.size)
    kw = dict(kw)
    if name == "davidson":
        kw["prec"] = drv.dist_jacobi(a, dm.row_map)
    v0 = lobpcg_v0(a.shape[0]) if name == "lobpcg_v0" else None
    res = drv.dist_eigsolve(getattr(E, solver), dm, nev, comm=comm, v0=v0,
                            device=device, **kw)
    # LOBPCG's result has no converged field: it stops converged or at
    # maxiter, which its iteration count shows
    return dict(vals=res.eigenvalues, iters=int(res.iters),
                converged=bool(getattr(res, "converged", True)),
                vecs=res.eigenvectors,
                resnorms=np.asarray(getattr(res, "resnorms", ())))


def _sstep(comm, device, dims, dtype, kw, b_seed, **extra):
    op = laplace3d(*dims, dtype=dtype, fmt="stencil")
    rmap = Map.uniform(op.n_rows, comm.size)
    b = _local(rmap, vectors(op.n_rows, b_seed), comm.index(), device).to(
        torch.float32 if dtype == np.float32 else torch.float64)
    res = drv.dist_sstep_gmres(op, b, comm=comm, **kw, **extra)
    return dict(x=res.x, iters=int(res.iters), resnorm=float(res.resnorm),
                converged=bool(res.converged))


def _sstep_fused(comm, device):
    out = _sstep(comm, device, SSTEP_DIMS, np.float32, SSTEP_KW, 42)
    # the same solve with σ given as the single-card estimator's value on
    # the global operator: rank 0's broadcast estimate is that value
    op = laplace3d(*SSTEP_DIMS, dtype=np.float32, fmt="stencil")
    sig = estimate_opnorm(lambda v: spmv(op, v), op.n_rows_pad,
                          torch.float32, device=device)
    given = _sstep(comm, device, SSTEP_DIMS, np.float32, SSTEP_KW, 42,
                   sigma=sig)
    out.update(sigma=sig, given_iters=given["iters"],
               given_resnorm=given["resnorm"])
    return out


def _entry(name, comm, device):
    """This rank's result of a distributed entry at its small grid, its
    right-hand side, and (rank 0) the single-card twin's result."""
    me, p = comm.index(), comm.size
    dims = ENTRY_SMALL[name]
    single = None
    if name == "sstep":
        step, (b,) = dist_sstep_entry(dims, n_ranks=p, comm=comm,
                                      device=device)
        res = step(b)
        if me == 0:
            st, (bs,) = sstep_entry(dims, device=device)
            single = st(bs)
    elif name == "eigen":
        step, _ = dist_eigen_entry(dims, nev=4, n_ranks=p, comm=comm,
                                   device=device)
        res = step()
        b = None
        if me == 0:
            amg = SaAmg(laplace3d(*dims, dtype=np.float64, fmt="stencil"),
                        {"dtype": np.float64}, device=device).compute()
            st, args = eigen_entry("LOBPCG", {"Which": "SR",
                                              "Convergence Tolerance": 1e-8},
                                   nev=4, amg=amg)
            single = st(*args)
    else:
        step, (b,) = dist_schwarz_entry(dims, n_ranks=p, comm=comm,
                                        device=device)
        res = step(b)
    if name == "eigen":
        out = dict(vals=np.asarray(res.eigenvalues), iters=int(res.iters),
                   x=res.eigenvectors, converged=True)
    else:
        out = dict(x=res.x, iters=int(res.iters),
                   resnorm=float(res.resnorm),
                   converged=bool(res.converged), b=b)
    if single is not None:
        out["single"] = dict(iters=int(single.iters),
                             x=single.eigenvectors if name == "eigen"
                             else single.x,
                             vals=(np.asarray(single.eigenvalues)
                                   if name == "eigen" else None),
                             resnorm=(None if name == "eigen"
                                      else float(single.resnorm)))
    return out


def _global_op(comm, device):
    me, p = comm.index(), comm.size
    a = laplace2d(*GLOBAL_OP_GRID)
    dm = D.distribute(a, p)
    op = drv.global_operator(dm, comm, device)
    n = a.shape[0]
    return {label: op(_local(dm.row_map, x, me, device))
            for label, x in (("1d", vectors(n, 12)),
                             ("k4", vectors(n, 13, K)))}


def _mass_refused(comm, device):
    """dist_eigsolve binds no mass matrix to lanczos_eigs's basis length:
    the message of the ValueError it raises."""
    dm = D.distribute(laplace2d(*GLOBAL_OP_GRID), comm.size)
    try:
        drv.dist_eigsolve(E.lanczos_eigs, dm, 2, comm=comm, device=device,
                          mass_matrix=dm, dtype=np.float64)
    except ValueError as err:
        return str(err)
    return None


RANK_CASES = {
    "sstep/fused": _sstep_fused,
    "sstep/loop": lambda comm, device: _sstep(
        comm, device, SSTEP_DIMS, np.float32, SSTEP_KW, 42, basis="loop"),
    "sstep/newton": lambda comm, device: _sstep(
        comm, device, SSTEP_DIMS, np.float64, SSTEP_NEWTON_KW, 42,
        shifts=SSTEP_NEWTON_SHIFTS),
    "sstep/bf16": lambda comm, device: _sstep(
        comm, device, SSTEP_BF16_DIMS, np.float32, SSTEP_BF16_KW, 3,
        basis_dtype=torch.bfloat16),
    **{f"eigen/{name}": (lambda comm, device, name=name:
                         _eigen(name, comm, device))
       for name in EIGEN_CASES if name != "lobpcg"},
    "eigen/global_op": _global_op,
    "eigen/mass_refused": _mass_refused,
    # GMRES with restricted Schwarz: the entry on the twin's grid
    "schwarz/gmres": lambda comm, device: _entry("schwarz", comm, device),
    "entry/sstep": lambda comm, device: _entry("sstep", comm, device),
    "entry/eigen": lambda comm, device: _entry("eigen", comm, device),
}


# -- rank grids, Domi's MDMap/MDVector and Pliris ----------------------------

# the twin of tests/test_dist_twolevel.py: laplace2d 16² over a (2, 4) grid
# and over the flat group of 8
GRID_SHAPE = (2, 4)
GRID_LAPLACE = (16, 16)
GRID_KW = {"cg": dict(rtol=1e-10, maxiter=400),
           "gmres": dict(rtol=1e-8, maxiter=400, restart=30),
           "lsqr": dict(rtol=1e-8, maxiter=600)}


def _grid_run(al, a, rmap, x, b, comm):
    out = {"spmv": drv.dist_spmv(al, x, comm),
           "spmv_t": drv.dist_spmv_t(al, x, comm)}
    runs = {"cg": lambda: drv.dist_solve(cg, al, b, comm=comm,
                                         prec=drv.dist_jacobi(a, rmap),
                                         **GRID_KW["cg"]),
            "gmres": lambda: drv.dist_solve(gmres, al, b, comm=comm,
                                            **GRID_KW["gmres"]),
            "lsqr": lambda: drv.dist_lsqr(al, b, comm=comm,
                                          **GRID_KW["lsqr"])}
    for name, run in runs.items():
        res = run()
        out[name] = dict(x=res.x, iters=int(res.iters),
                         converged=bool(res.converged))
    return out


def grid_cases(comm, device):
    """The (2, 4) grid's layout, ``solve_axes``, the refused sizes, and
    every apply and solve of the twin on the grid and on the flat
    group."""
    me = comm.index()
    out = {}
    for label, shape in (("too_many", (4, 4)), ("too_few", (2, 2))):
        try:
            drv.make_mesh2(comm, *shape)
            out[label] = None
        except ValueError as err:
            out[label] = str(err)
    grid = drv.make_mesh2(comm, *GRID_SHAPE)
    out.update(solve_axes=(drv.solve_axes(grid), drv.solve_axes(comm)),
               coords=grid.coords, index=grid.index(),
               axis_ranks=tuple(grid.axis(nm).rank
                                for nm in grid.axis_names),
               axis_sizes=tuple(grid.axis(nm).size
                                for nm in grid.axis_names))
    a = laplace2d(*GRID_LAPLACE)
    dm = D.distribute(a, comm.size)
    al = dm.local(me, device)
    n = a.shape[0]
    x = _local(dm.row_map, vectors(n, 20), me, device)
    b = _local(dm.row_map, vectors(n, 21), me, device)
    out["grid"] = _grid_run(al, a, dm.row_map, x, b, grid)
    out["flat"] = _grid_run(al, a, dm.row_map, x, b, comm)
    return out


# the twin of tests/test_mdarray.py on a (2, 4) grid (axes x, y) and a
# (2, 2, 2) one (x, y, z): case → (global shape, grid axes, halo, periodic,
# seed)
def lap5(u):
    """5-point Laplacian on a 1-cell-padded block."""
    c = u[1:-1, 1:-1]
    return (4.0 * c - u[:-2, 1:-1] - u[2:, 1:-1]
            - u[1:-1, :-2] - u[1:-1, 2:])


def lap7(u):
    """7-point Laplacian on a 1-cell-padded block, its terms in the order of
    Galeri's cross with x the last axis (``stencil_block_fn``'s order)."""
    c = u[1:-1, 1:-1, 1:-1]
    return (6.0 * c
            - u[1:-1, 1:-1, :-2] - u[1:-1, 1:-1, 2:]
            - u[1:-1, :-2, 1:-1] - u[1:-1, 2:, 1:-1]
            - u[:-2, 1:-1, 1:-1] - u[2:, 1:-1, 1:-1])


def diag9(u):
    return u[:-2, :-2] + u[2:, 2:] + u[:-2, 2:] + u[2:, :-2]


def shift2(u):
    return u[:-4, :]  # the value from 2 rows above


MD_APPLIES = {
    "dirichlet": ((16, 32), ("x", "y"), (1, 1), (False, False), 0, lap5),
    "periodic": ((16, 32), ("x", "y"), (1, 1), (True, True), 1, lap5),
    "corner": ((8, 16), ("x", "y"), (1, 1), (True, True), 2, diag9),
    "halo2": ((16, 16), ("x", "y"), (2, 0), (True, False), 3, shift2),
    "local_axis": ((16, 16), ("x", None), (1, 1), (False, True), 4, lap5),
}
MD_POLY_STAGES = ((0.0, 0.0, 0.0, 0.25), (-0.2, 1.0, 0.0, 0.25),
                  (-0.2, 1.05, -0.3, 0.2))  # a Chebyshev-like chain
MD_CA = dict(lmax=1.9, lmin=0.06, degree=3, dinv=0.25)


def md_field(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


def md_cases(comm, device):
    """Every case of the mdarray twin on this rank: layouts, the refused
    maps, the applies and dots gathered, the md CGs' iterations and
    gathered x, the CA sweep against chained applies."""
    g2 = ProcessGrid(comm, (2, 4), ("x", "y"))
    g3 = ProcessGrid(comm, (2, 2, 2), ("x", "y", "z"))
    out = {}
    md = MD.MDMap((16, 32), ("x", "y"), halo=(1, 1))
    arange = np.arange(16 * 32, dtype=np.float64).reshape(16, 32)
    out["layout"] = dict(
        local_shape=md.local_shape(g2),
        mixed=MD.MDMap((16, 32, 3), ("x", "y", None)).local_shape(g2),
        gathered=md.gather(md.local_block(arange, g2, device), g2))
    for label, make in (
            ("indivisible",
             lambda: MD.MDMap((15, 32), ("x", "y")).local_shape(g2)),
            ("halo_mismatch", lambda: MD.md_poly_apply(
                md, g2, lap5, ((1.0, 0, 0, 0), (1.0, 0, 0, 0))))):
        try:
            make()
            out[label] = None
        except ValueError as err:
            out[label] = str(err)
    for name, (shape, axes, halo, per, seed, fn) in MD_APPLIES.items():
        mdm = MD.MDMap(shape, axes, halo=halo, periodic=per)
        blk = mdm.local_block(md_field(shape, seed), g2, device)
        out[name] = mdm.gather(MD.md_map_apply(mdm, g2, fn)(blk), g2)
    rng = np.random.default_rng(5)
    fa, fb = rng.standard_normal((16, 32)), rng.standard_normal((16, 32))
    out["md_dot"] = float(MD.md_dot(g2)(md.local_block(fa, g2, device),
                                       md.local_block(fb, g2, device)))

    def solve(label, solver, mdm, grid, fn, seed, **kw):
        res = MD.md_solve(solver, mdm, grid, fn, mdm.local_block(
            md_field(mdm.global_shape, seed), grid, device), **kw)
        out[label] = dict(iters=int(res.iters), converged=bool(res.converged),
                          x=mdm.gather(res.x, grid))

    solve("cg_2d", cg, md, g2, lap5, 7, rtol=1e-12, maxiter=2000)
    solve("cg_3d", cg_single_reduce,
          MD.MDMap((8, 8, 16), ("x", "y", "z"), halo=(1, 1, 1)), g3, lap7, 8,
          rtol=1e-12, maxiter=3000)
    for per in (False, True):
        s = len(MD_POLY_STAGES)
        deep = MD.MDMap((16, 32), ("x", "y"), halo=(s, s),
                        periodic=(per, per))
        one = MD.MDMap((16, 32), ("x", "y"), halo=(1, 1),
                       periodic=(per, per))
        x0 = one.local_block(md_field((16, 32), 11), g2, device)
        got = MD.md_poly_apply(deep, g2, lap5, MD_POLY_STAGES)(x0)
        # the reference: chained single applies with a full exchange each
        apply1 = MD.md_map_apply(one, g2, lap5)
        u_prev2, u_prev = torch.zeros_like(x0), x0
        for (a, bt, g, z) in MD_POLY_STAGES:
            u = torch.zeros_like(x0)
            if a:
                u = a * apply1(u_prev)
            if bt:
                u = u + bt * u_prev
            if g:
                u = u + g * u_prev2
            if z:
                u = u + z * x0
            u_prev2, u_prev = u_prev, u
        out[f"chained/{per}"] = dict(poly=deep.gather(got, g2),
                                     chained=one.gather(u_prev, g2))
    deg = MD_CA["degree"]
    prec = MD.md_poly_local(
        MD.MDMap((16, 32), ("x", "y"), halo=(deg, deg)), g2, lap5,
        chebyshev_stages(MD_CA["lmax"], MD_CA["lmin"], deg, MD_CA["dinv"]))
    solve("ca_cg", cg, md, g2, lap5, 12, prec_local=prec, rtol=1e-11,
          maxiter=500)
    solve("ca_cg_plain", cg, md, g2, lap5, 12, rtol=1e-11, maxiter=500)
    try:
        MD.md_solve(cg, md, g2, lap5, md.local_block(arange, g2, device),
                    prec_local=prec, prec=lambda v: v)
        out["both_precs"] = None
    except ValueError as err:
        out["both_precs"] = str(err)
    out["staged"] = g2.staged_bytes + g3.staged_bytes
    return out


MD_ENTRY_DIMS = (16, 16, 16)  # dist_md_entry on a (2, 2, 1) grid of 4


def md_entry_case(comm, device):
    step, (b,) = dist_md_entry(MD_ENTRY_DIMS, comm=comm, dtype=np.float64,
                               device=device)
    res = step(b)
    return dict(iters=int(res.iters), converged=bool(res.converged),
                x=step.mdmap.gather(res.x, step.grid),
                b=step.mdmap.gather(b, step.grid), coords=step.grid.coords)


# the twin of tests/test_pliris.py on 8 ranks: case → (n, nb, seed, zero
# leading diagonal, right-hand sides)
PLIRIS_CASES = {"128-16": (128, 16, 1, False, None),
                "256-32": (256, 32, 1, False, None),
                "pivot": (128, 16, 2, True, None),
                "rhs5": (128, 16, 3, False, 5),
                "crossing": (64, 8, 5, False, None)}


def pliris_system(n, seed, need_pivot=False, k=None):
    """The JAX package's ``_system``: a + n·I (or a with a zero leading
    diagonal) and b, with k columns of seed-4 normals for ``k``."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    if need_pivot:
        a[0, 0] = 0.0
        a[1, 1] = 0.0
    else:
        a += n * np.eye(n)
    b = rng.standard_normal(n)
    if k is not None:
        b = np.random.default_rng(4).standard_normal((n, k))
    return a, b


def pliris_cases(comm, device):
    out = {name: dist_dense_solve(comm, *pliris_system(n, seed, piv, k),
                                  nb=nb, device=device)
           for name, (n, nb, seed, piv, k) in PLIRIS_CASES.items()}
    a, b = pliris_system(64, 0)
    for label, args, nb in (("divisible", (a[:60, :60], b[:60]), 128),
                            ("square", (a[:, :32], b), 128),
                            ("panel", (a, b), 3)):
        try:
            dist_dense_solve(comm, *args, nb=nb, device=device)
            out[label] = None
        except ValueError as err:
            out[label] = str(err)
    return out
