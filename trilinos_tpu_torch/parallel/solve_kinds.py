"""Distributed coverage of every factory solver kind and eigensolver kind.

Counterpart of ``trilinos_tpu/parallel/solve_kinds.py``. The reference
tests every Belos solver at 1..8 MPI ranks through a per-solver CMake
matrix (packages/belos/tpetra/test/BlockGmres/CMakeLists.txt:38
NUM_MPI_PROCS; the same pattern for BlockCG, BiCGStab, ...). Here
:func:`run_all_solver_kinds` runs one distributed solve per kind of
``solvers.factory.ALIASES`` and :func:`run_all_eigen_kinds` one
distributed eigensolve per kind of ``eigen.factory.ALIASES`` (the
mass-aware kinds again as a pencil), in every rank of a group:

* the kinds whose drivers run whole inside one rank-local program go
  through ``driver.dist_solve`` with adapters of its solver signature
  ``(op, b, x0=, prec=, comm=) -> SolveResult`` (the JAX package's
  ``shard_map`` adapters): the block drivers on a single right-hand side
  promoted to one column, PCPG with the normalised right-hand side as its
  constraint basis, s-step GMRES with a fixed σ and the loop basis;
* the host-driven kinds (recycle spaces, the GMRES polynomial) run over
  ``driver.global_operator`` / ``driver.global_precond``, the rank-local
  closures that stand for the JAX package's global view;
* LSQR runs through ``driver.dist_lsqr`` (it needs A and Aᵀ).

Both gates assert coverage against the port's own factory tables before
any solve, run every kind, and raise one ``RuntimeError`` listing every
kind that failed. The failures are reduced over the group before that
raise, so every rank reaches the same verdict and none leaves the group
on its own. This module is the engine behind ``entry.dryrun_multichip``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .comm import Comm, norm2


def _shard_map_adapters(rtol: float, maxiter: int) -> dict:
    """kind -> adapter with ``driver.dist_solve``'s solver signature
    ``(op, b, x0=None, prec=None, comm=None) -> SolveResult``."""
    from ..solvers import (bicgstab, block_cg, block_gmres, cg, cg_pipeline,
                           cg_single_reduce, fgmres, fixed_point, gmres,
                           gmres_pipeline, gmres_single_reduce, minres,
                           pcpg, sstep_gmres, stochastic_cg, tfqmr)
    from ..solvers.base import SolveResult

    kw = dict(rtol=rtol, maxiter=maxiter)
    gkw = dict(rtol=rtol, maxiter=maxiter, restart=4)

    def plain(fn, **fkw):
        def run(op, b, x0=None, prec=None, comm=None):
            return fn(op, b, x0, prec=prec, comm=comm, **fkw)
        return run

    def first(fn, **fkw):
        # drivers that return (SolveResult, extra)
        def run(op, b, x0=None, prec=None, comm=None):
            return fn(op, b, x0, prec=prec, comm=comm, **fkw)[0]
        return run

    def pcpg_adapter(op, b, x0=None, prec=None, comm=None):
        # constraint basis: the normalised right-hand side (any fixed
        # subspace serves a coverage gate; FETI passes rigid-body modes)
        basis = (b / norm2(comm, b))[:, None]
        return pcpg(op, b, basis, x0, comm=comm, **kw)

    def sstep_adapter(op, b, x0=None, prec=None, comm=None):
        # σ is given, as the JAX package's shard_map program must
        return sstep_gmres(op, b, x0, s=2, t_blocks=2, max_restarts=1,
                           sigma=4.0, prec=prec, basis_impl="loop",
                           rtol=rtol, comm=comm)

    def unblock(fn, **fkw):
        # a block driver on a single right-hand side promoted to (n, 1),
        # its column axis stripped again
        def run(op, b, x0=None, prec=None, comm=None):
            res = fn(op, b[:, None], None if x0 is None else x0[:, None],
                     prec=prec, comm=comm, **fkw)
            return SolveResult(x=res.x[:, 0], iters=res.iters,
                               resnorm=torch.as_tensor(res.resnorm).max(),
                               converged=torch.as_tensor(res.converged).all())
        return run

    return {
        "cg": plain(cg, **kw),
        "cg_single_reduce": plain(cg_single_reduce, **kw),
        "cg_pipeline": plain(cg_pipeline, **kw),
        "stochastic_cg": first(stochastic_cg, **kw),
        "block_cg": unblock(block_cg, **kw),
        "gmres": plain(gmres, **gkw),
        "fgmres": plain(fgmres, **gkw),
        "block_gmres": unblock(block_gmres, num_blocks=4, max_restarts=1,
                               rtol=rtol),
        "gmres_sr": plain(gmres_single_reduce, **gkw),
        "gmres_pipe": plain(gmres_pipeline, **gkw),
        "bicgstab": plain(bicgstab, **kw),
        "minres": plain(minres, **kw),
        "tfqmr": plain(tfqmr, **kw),
        "fixed_point": plain(fixed_point, omega=0.5, **kw),
        "pcpg": pcpg_adapter,
        "sstep": sstep_adapter,
    }


def _global_view_kinds(gop, gprec, bg, comm: Comm, rtol: float,
                       maxiter: int) -> dict:
    """kind -> thunk for the host-driven drivers (recycle spaces, the
    GMRES polynomial's Arnoldi) over the rank-local closures of the global
    operator and preconditioner."""
    from ..precond.poly import gmres_poly_apply, gmres_poly_setup
    from ..solvers import block_gcrodr, gcrodr, gmres, rcg

    def hybrid():
        h, y, deg = gmres_poly_setup(gop, bg, 4, comm=comm)
        return gmres(gop, bg, prec=lambda v: gmres_poly_apply(
            gop, h, y, deg, v), restart=4, rtol=rtol, maxiter=maxiter,
            comm=comm)

    # gprec rides through the drivers' own prec=, so a broken
    # global_precond fails the gate
    return {
        "gcrodr": lambda: gcrodr(gop, bg, prec=gprec, num_blocks=4,
                                 recycle_dim=2, max_cycles=2, rtol=rtol,
                                 comm=comm)[0],
        "block_gcrodr": lambda: block_gcrodr(
            gop, torch.stack([bg, 0.5 * bg], dim=1), prec=gprec,
            num_blocks=4, recycle_dim=2, max_cycles=2, rtol=rtol,
            comm=comm)[0],
        "rcg": lambda: rcg(gop, bg, prec=gprec, recycle_dim=2, rtol=rtol,
                           maxiter=maxiter, comm=comm)[0],
        "hybrid_gmres": hybrid,
    }


def _verdict(comm: Comm, kinds: list, failures: dict, device,
             what: str) -> None:
    """Raise on every rank when a kind failed on any rank: one row of
    failure flags a rank, summed over the group, so that each rank reads
    the same table."""
    me, p = comm.index(), comm.size
    flags = torch.zeros((p, len(kinds)), dtype=torch.float64, device=device)
    flags[me] = torch.tensor([k in failures for k in kinds],
                             dtype=torch.float64)
    table = comm.psum(flags).cpu().numpy() > 0
    failed = [k for j, k in enumerate(kinds) if table[:, j].any()]
    if not failed:
        return
    lines = []
    for k in failed:
        ranks = [int(r) for r in np.flatnonzero(table[:, kinds.index(k)])]
        why = failures.get(k, "failed on another rank")
        lines.append(f"  {k} (ranks {ranks}): {why[:300]}")
    raise RuntimeError(
        f"{len(failed)} distributed {what} kind(s) FAILED on the {p}-rank "
        f"group:\n" + "\n".join(lines))


def run_all_solver_kinds(comm: Comm, device=None, *, rtol: float = 1e-4,
                         maxiter: int = 6) -> dict:
    """Solve once with every implementation kind the solver factory
    exposes, in every rank of ``comm``'s group, on Galeri laplace2d(12,
    2·p) in float32 with a Jacobi ``DistPrecond`` and seed-0 normals;
    ``device`` (``None``: the card) holds the rank's vectors. Returns
    {kind: SolveResult}, x the rank's padded local rows. Raises
    RuntimeError before any solve if a factory kind has no distributed
    coverage, and after them all, on every rank, listing every kind that
    failed on any rank."""
    from ..galeri import laplace2d
    from ..solvers import factory as fct
    from . import distmatrix as D
    from . import driver as drv

    dev = resolve_device(device)
    adapters = _shard_map_adapters(rtol, maxiter)
    p, me = comm.size, comm.index()
    a = laplace2d(12, 2 * p, dtype=np.float32)
    dm = D.distribute(a, p)
    al = dm.local(me, dev)
    prec = drv.dist_jacobi(a, dm.row_map, dtype=np.float32)
    b = np.random.default_rng(0).standard_normal(a.shape[0]).astype(
        np.float32)
    bg = torch.from_numpy(dm.row_map.local_chunk(
        dm.row_map.to_padded(b), me).copy()).to(dev)

    gop = drv.global_operator(al, comm)
    gprec = drv.global_precond(prec, al, comm)
    gkinds = _global_view_kinds(gop, gprec, bg, comm, rtol, maxiter)

    all_kinds = sorted(set(fct.ALIASES.values()))
    covered = set(adapters) | set(gkinds) | {"lsqr"}  # lsqr: dist_lsqr
    missing = set(all_kinds) - covered
    if missing:
        raise RuntimeError(
            f"factory kinds with no distributed coverage: {sorted(missing)}"
            " — add adapters in parallel/solve_kinds.py")

    results, failures = {}, {}
    for kind in all_kinds:
        try:
            if kind == "lsqr":
                res = drv.dist_lsqr(al, bg, comm=comm, rtol=rtol,
                                    maxiter=maxiter)
            elif kind in adapters:
                res = drv.dist_solve(adapters[kind], al, bg, comm=comm,
                                     prec=prec)
            else:
                res = gkinds[kind]()
            if res.x.shape[0] != bg.shape[0]:
                raise AssertionError(
                    f"bad solution shape {tuple(res.x.shape)} vs "
                    f"{tuple(bg.shape)}")
            results[kind] = res
        except Exception as e:  # noqa: BLE001 — the gate reports them all
            failures[kind] = f"{type(e).__name__}: {e}"
    _verdict(comm, all_kinds, failures, dev, "solver")
    return results


def run_all_eigen_kinds(comm: Comm, device=None, *, tol: float = 1e-3,
                        maxiter: int = 40) -> dict:
    """Eigensolve once with every kind the eigensolver factory exposes, in
    every rank of ``comm``'s group, on Galeri laplace2d(8, 2·p) in float64
    stored as ELL (two pairs, one for the power method), and every
    mass-aware kind again as the pencil with M = A (the Anasazi setM
    surface). Same contract as :func:`run_all_solver_kinds`: coverage
    asserted against ``eigen.factory.ALIASES`` first, one RuntimeError on
    every rank listing every failing kind. Returns {kind: result} (LANCZOS
    its (θ, vectors) pair)."""
    from ..eigen import (block_davidson, block_krylov_schur,
                         generalized_davidson, lanczos_eigs, lobpcg,
                         power_method, rtr, tracemin)
    from ..eigen import factory as efct
    from ..galeri import laplace2d
    from . import distmatrix as D
    from . import driver as drv

    dev = resolve_device(device)
    a = laplace2d(8, 2 * comm.size, dtype=np.float64)
    dm = D.distribute(a, comm.size, fmt="ell")
    al = dm.local(comm.index(), dev)
    common = dict(comm=comm, tol=tol, maxiter=maxiter)

    def bks(**kw):
        return drv.dist_eigsolve(block_krylov_schur, al, 2, comm=comm,
                                 tol=tol, **kw)

    runners = {
        "lobpcg": lambda: drv.dist_eigsolve(lobpcg, al, 2, which="LM",
                                            **common),
        "davidson": lambda: drv.dist_eigsolve(block_davidson, al, 2,
                                              which="LA", **common),
        "gen_davidson": lambda: drv.dist_eigsolve(
            generalized_davidson, al, 2, which="LR", **common),
        "tracemin": lambda: drv.dist_eigsolve(tracemin, al, 2, **common),
        "rtr": lambda: drv.dist_eigsolve(rtr, al, 2, **common),
        "bks": bks,
        "lanczos": lambda: drv.dist_eigsolve(lanczos_eigs, al, 2, comm=comm,
                                             which="LM"),
        "power": lambda: drv.dist_eigsolve(power_method, al, 1, comm=comm,
                                           tol=tol, maxiter=maxiter),
        # the mass-aware kinds again as pencils (M = the same SPD matrix:
        # every eigenvalue 1), through the distributed mass operator
        "lobpcg+M": lambda: drv.dist_eigsolve(
            lobpcg, al, 2, which="LM", mass_matrix=al, **common),
        "davidson+M": lambda: drv.dist_eigsolve(
            block_davidson, al, 2, which="LA", mass_matrix=al, **common),
        "gen_davidson+M": lambda: drv.dist_eigsolve(
            generalized_davidson, al, 2, which="LR", mass_matrix=al,
            **common),
        "tracemin+M": lambda: drv.dist_eigsolve(
            tracemin, al, 2, mass_matrix=al, **common),
        "rtr+M": lambda: drv.dist_eigsolve(rtr, al, 2, mass_matrix=al,
                                           **common),
        "bks+M": lambda: bks(mass_matrix=al, m_solve_iters=20),
    }
    missing = set(efct.ALIASES.values()) - {k.split("+")[0]
                                             for k in runners}
    if missing:
        raise RuntimeError(
            f"eigen kinds with no distributed coverage: {sorted(missing)}"
            " — add runners in parallel/solve_kinds.py")

    results, failures = {}, {}
    kinds = sorted(runners)
    for kind in kinds:
        try:
            res = runners[kind]()
            # lanczos_eigs returns (θ, vectors); the rest a result object
            ev = torch.as_tensor(res[0] if isinstance(res, tuple)
                                 else res.eigenvalues)
            if not bool(torch.isfinite(ev).all()):
                raise AssertionError(f"non-finite eigenvalues {ev}")
            results[kind] = res
        except Exception as e:  # noqa: BLE001 — the gate reports them all
            failures[kind] = f"{type(e).__name__}: {e}"
    _verdict(comm, kinds, failures, dev, "eigensolver")
    return results
