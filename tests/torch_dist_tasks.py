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

from trilinos_tpu_torch.entry import dist_amg_entry, dist_pipelined_cg_entry
from trilinos_tpu_torch.galeri import laplace2d, laplace3d, recirc2d
from trilinos_tpu_torch.io import read_sparse_distributed
from trilinos_tpu_torch.ops.formats import CsrHost
from trilinos_tpu_torch.parallel import dist_setup
from trilinos_tpu_torch.parallel import distmatrix as D
from trilinos_tpu_torch.parallel import driver as drv
from trilinos_tpu_torch.solvers import cg, gmres

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
    """Every rank's result of each named solve case."""
    return {name: _solve_case(name, comm, device) for name in cases}


def ranks_fail_one(comm, device):
    """Rank 1 raises before a reduction that rank 0 then waits in."""
    if comm.index() == 1:
        raise ValueError("rank body failed on purpose")
    comm.psum(torch.ones(1))
    return "unreachable"
