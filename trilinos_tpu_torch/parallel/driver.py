"""Distributed drivers: rank processes, distributed preconditioners and the
per-rank solve entry points.

Counterpart of ``trilinos_tpu/parallel/driver.py``. The JAX package runs
P shards as one program under ``shard_map`` over a mesh; here each rank is
its own process with a ``torch.distributed`` process group, the way
Trilinos runs one MPI process a rank:

* :func:`launch` (the counterpart of ``make_mesh``) spawns P rank
  processes with the ``spawn`` start method and a ``file://`` rendezvous
  in a directory the caller gives, hands each a device and a backend, runs
  ``fn(comm, device, *args)`` in every rank and gathers what each returns.
  It joins with a timeout: a rank that hangs (a collective its peers never
  enter) or fails stops every rank, and the launcher raises;
* :func:`make_mesh2` lays a rank's group out as a two-axis
  :class:`~.comm.ProcessGrid` (outer-major, as the JAX package's two-level
  mesh), which every driver below takes where it takes a comm;
  :func:`solve_axes` names the axes a solve's rows run over;
* :func:`dist_spmv`, :func:`dist_spmv_t`, :func:`dist_solve`,
  :func:`dist_lsqr` and :func:`dist_sstep_gmres` run inside a rank on that
  rank's padded local vector, with any solver of
  ``trilinos_tpu_torch.solvers`` and the rank's :class:`~.comm.ProcessComm`;
  ``iters``, ``resnorm`` and ``converged`` come from reductions and are the
  same on every rank;
* :func:`global_operator`, :func:`global_precond` and
  :func:`dist_eigsolve`: the operator and preconditioner as rank-local
  closures, and any eigensolver of ``trilinos_tpu_torch.eigen`` run in
  every rank over them;
* :class:`DistPrecond` keeps every rank's preconditioner state on the host
  (arrays stacked on a leading rank axis, or host DistMatrix levels) and
  ``make(comm, op, device)`` builds the rank's apply (the Ifpack2 split:
  row-partitioned state, per-rank apply), Schwarz's overlapped subdomains
  (:func:`dist_schwarz`) among the kinds.

Kernels are chosen by the tensor's device, never by probing the platform:
on the card the interior and stencil applies launch the port's kernels,
on the CPU they run the plain versions, and a shape a kernel's plan
refuses raises.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device, torch_dtype
from ..ops.formats import CsrHost, EllMatrix
from ..solvers.base import SolveResult
from .comm import Comm, ProcessComm, ProcessGrid
from .distmatrix import (DistMatrix, DistStencil, HaloPlan, LocalStencil,
                         _move, _tensor, apply_local, apply_local_stencil,
                         apply_local_transpose)
from .map import Map

# ---------------------------------------------------------------------------
# rank processes
# ---------------------------------------------------------------------------


def _to_host(tree):
    """Tensors in a rank's result as numpy (plain data crosses the
    process boundary)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_to_host(v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {f.name: _to_host(getattr(tree, f.name))
                for f in dataclasses.fields(tree)}
    return tree


def _rank_main(rank, n_ranks, init_file, backend, device, fn, args, out_q,
               pg_timeout):
    """Body of one rank process."""
    try:
        dev = torch.device(device)
        if dev.type == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=f"file://{init_file}",
            world_size=n_ranks, rank=rank,
            timeout=datetime.timedelta(seconds=pg_timeout))
        comm = ProcessComm()
        out = fn(comm, dev, *args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out_q.put((rank, True, _to_host(out)))
    except BaseException:
        out_q.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _stop(procs, grace: float) -> None:
    """Join the ranks for ``grace`` seconds, then terminate and kill what
    is left."""
    deadline = time.monotonic() + grace
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(5.0)
        if p.is_alive():
            p.kill()
            p.join(5.0)


def launch(fn: Callable, n_ranks: int, *args, device=None, backend=None,
           rendezvous_dir=None, timeout: float = 600.0,
           start_method: str = "spawn") -> list:
    """Run ``fn(comm, device, *args)`` in ``n_ranks`` rank processes and
    return their results in rank order (tensors as numpy).

    ``fn`` must be a module-level function (the ranks import it by name)
    whose module imports only the port. ``device``: ``None`` → the CUDA
    card (rank r takes card r mod the card count; raises without one),
    ``"cpu"`` → the CPU, where each rank runs one thread (torch's intra-op
    pool, and OpenMP and BLAS through the environment the ranks start
    with). On the card the kernels and the native library are built before
    any rank starts.
    ``backend``: ``None`` → ``nccl`` when every rank has a card of its own,
    else ``gloo`` (NCCL refuses two ranks on one card; gloo stages CUDA
    buffers through host memory, see ``ProcessComm``). The process group
    meets in a file under ``rendezvous_dir`` (a fresh temporary directory
    by default). After ``timeout`` seconds, or as soon as one rank fails,
    every rank is stopped and the launcher raises (``TimeoutError`` or
    ``RuntimeError`` with the rank's traceback)."""
    import multiprocessing as mp

    kind = "cuda" if device is None else torch.device(device).type
    if kind == "cuda":
        from .. import native
        from ..ops import _build

        resolve_device(None)  # raises without a card
        # built here, once, so that the ranks load them and never race on
        # the build directory
        _build.build()
        native.build()
        n_cards = torch.cuda.device_count()
        devices = [f"cuda:{r % n_cards}" for r in range(n_ranks)]
        backend = backend or ("nccl" if n_ranks <= n_cards else "gloo")
    elif kind == "cpu":
        devices = ["cpu"] * n_ranks
        backend = backend or "gloo"
    else:
        raise ValueError(f"ranks run on cuda or cpu, not {device!r}")
    if backend == "nccl" and (kind != "cuda" or len(set(devices)) < n_ranks):
        raise ValueError("the nccl backend needs a card of its own for "
                         "every rank")
    ctx = mp.get_context(start_method)
    # a spawned rank reads these when its libraries load: P ranks on the
    # host's cores, one thread each
    env = ({k: "1" for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                             "MKL_NUM_THREADS")} if kind == "cpu" else {})
    with tempfile.TemporaryDirectory(dir=rendezvous_dir) as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        out_q = ctx.Queue()
        procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(r, n_ranks, init_file, backend, devices[r], fn, args,
                  out_q, max(timeout, 60.0)))
            for r in range(n_ranks)]
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            for p in procs:
                p.start()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k)
                else:
                    os.environ[k] = v
        results, deadline = {}, time.monotonic() + timeout
        try:
            while len(results) < n_ranks:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"ranks {sorted(set(range(n_ranks)) - set(results))} "
                        f"did not finish within {timeout:.0f} s")
                try:
                    rank, ok, payload = out_q.get(timeout=min(left, 0.5))
                except queue_mod.Empty:
                    for r, p in enumerate(procs):
                        if r not in results and p.exitcode not in (None, 0):
                            raise RuntimeError(
                                f"rank {r} exited with code {p.exitcode} "
                                f"without a result")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{payload}")
                results[rank] = payload
        finally:
            _stop(procs, 30.0 if len(results) == n_ranks else 0.0)
            out_q.close()
            out_q.join_thread()
    return [results[r] for r in range(n_ranks)]


AXIS = "rows"


def solve_axes(comm: Comm):
    """The axis name(s) a solve's rows are split over: ``'rows'`` for a flat
    group, else the grid's axis names, outer-major (the single name of a
    one-axis grid). Rows run over the grid's flattened ranks, which is the
    group's rank order, so the drivers need nothing more."""
    ax = comm.axis_names if isinstance(comm, ProcessGrid) else (AXIS,)
    return ax[0] if len(ax) == 1 else tuple(ax)


def make_mesh2(comm: ProcessComm, p_outer: int, p_inner: int,
               axes: tuple[str, str] = ("dcn", AXIS)) -> ProcessGrid:
    """Two-level rank layout: ``p_outer`` groups of ``p_inner`` ranks,
    outer-major, over ``comm``'s group (which it must cover). Pass it to
    any ``dist_*`` driver as its comm: a contiguous row Map puts a rank's
    halo neighbours on its own inner line except at the outer cuts, as the
    JAX package's (dcn, rows) mesh does."""
    return ProcessGrid(comm, (p_outer, p_inner), axes)


# ---------------------------------------------------------------------------
# per-rank operators
# ---------------------------------------------------------------------------


def _as_local(a, comm: Comm, device):
    """Rank ``comm.index()``'s part of a host DistMatrix or DistStencil on
    ``device``; a part already local is returned as it is."""
    if isinstance(a, (DistMatrix, DistStencil)):
        if a.row_map.n_shards != comm.size:
            raise ValueError(f"the matrix has {a.row_map.n_shards} parts, "
                             f"the group {comm.size} ranks")
        return a.local(comm.index(), device)
    return a


def local_op(al, comm: Comm) -> Callable:
    """The rank's operator closure for a LocalMatrix or LocalStencil."""
    if isinstance(al, LocalStencil):
        return lambda v: apply_local_stencil(
            al.sel, al.valid, al.op_local, al.depth, al.plan, v, comm)
    return lambda v: apply_local(al.interior, al.boundary, al.plan, v, comm)


def local_op_t(al, comm: Comm) -> Callable:
    """The rank's transpose closure (square LocalMatrix only)."""
    if isinstance(al, LocalStencil):
        raise NotImplementedError(
            "transpose apply on DistStencil: symmetric stencils satisfy "
            "Aᵀ = A; for general stencils distribute the stored format")
    if al.col_map is not None:
        raise NotImplementedError(
            "transpose of a rectangular DistMatrix — AMG stores R "
            "explicitly (distribute_rect) instead")
    return lambda v: apply_local_transpose(al.interior, al.boundary,
                                           al.plan, v, comm)


# ---------------------------------------------------------------------------
# distributed preconditioners
# ---------------------------------------------------------------------------


def _take(tree, s: int, device):
    """Rank s's part of host preconditioner state, on ``device``: stacked
    numpy arrays give their row s, host DistMatrix and HaloPlan their
    ``local(s)``."""
    if isinstance(tree, np.ndarray):
        return _tensor(tree[s], device)
    if isinstance(tree, (DistMatrix, DistStencil)):
        return tree.local(s, device)
    if isinstance(tree, HaloPlan):
        return tree.local(s, device)
    if isinstance(tree, dict):
        return {k: _take(v, s, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_take(v, s, device) for v in tree]
    return tree


def _replicate(tree, device):
    """State every rank holds whole (coarse inverses, replicated coarse
    levels) on ``device``."""
    if isinstance(tree, np.ndarray):
        return _tensor(tree, device)
    if isinstance(tree, torch.Tensor):
        return tree.to(resolve_device(device))
    if isinstance(tree, dict):
        return {k: _replicate(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_replicate(v, device) for v in tree]
    if dataclasses.is_dataclass(tree) and any(
            isinstance(getattr(tree, f.name), torch.Tensor)
            for f in dataclasses.fields(tree)):
        return _move(tree, device)
    return tree


@dataclasses.dataclass(frozen=True, eq=False)
class LocalPrecond:
    """One rank's preconditioner state on its device: ``local`` (the rank's
    rows), ``replicated`` (what every rank holds whole), ``kind`` and
    ``consts``."""

    local: dict
    replicated: dict
    kind: str
    consts: tuple = ()

    def make(self, comm: Comm, op: Callable) -> Callable:
        """The rank's apply; ``op`` is the rank's operator closure."""
        build = _KINDS.get(self.kind)
        if build is None:
            raise ValueError(f"unknown DistPrecond kind {self.kind!r}")
        return build(self, comm, op)


@dataclasses.dataclass(frozen=True, eq=False)
class DistPrecond:
    """Every rank's preconditioner state on the host and the recipe of the
    rank's apply. ``arrays`` leaves carry a leading rank axis (or are host
    DistMatrix / DistStencil levels); ``replicated`` holds what every rank
    keeps whole; ``consts`` are plain parameters."""

    arrays: dict
    kind: str
    consts: tuple = ()
    replicated: dict = dataclasses.field(default_factory=dict)

    def local(self, s: int, device=None) -> LocalPrecond:
        """Rank s's state on ``device`` (``None``: the card)."""
        dev = resolve_device(device)
        return LocalPrecond(local=_take(self.arrays, s, dev),
                            replicated=_replicate(self.replicated, dev),
                            kind=self.kind, consts=self.consts)

    def make(self, comm: Comm, op: Callable, device=None) -> Callable:
        """The apply of rank ``comm.index()`` with its state on ``device``;
        ``op`` is the rank's operator closure."""
        return self.local(comm.index(), device).make(comm, op)


def _identity(pc, comm, op):
    return lambda x: x


def _jacobi(pc, comm, op):
    dinv = pc.local["dinv"]
    return lambda x: (dinv if x.ndim == 1 else dinv[:, None]) * x


def _ilu_sweeps(local: dict, sweeps: int) -> Callable:
    """The fixed-sweep Jacobi triangular solves with a rank's ELL factors
    L (unit lower, diagonal stored) and U (``l_cols``, ``l_vals``,
    ``u_cols``, ``u_vals``, ``udinv``): the FastILU apply that
    ``dist_ilu0`` and the Schwarz subdomain solves share."""
    from ..ops.matvec import spmv

    def mk(cols, vals):
        n = cols.shape[0]
        return EllMatrix(cols=cols, vals=vals, n_rows=n, n_cols=n, nnz=0)

    l_m = mk(local["l_cols"], local["l_vals"])
    u_m = mk(local["u_cols"], local["u_vals"])
    udinv_v = local["udinv"]

    def ilu_apply(r):
        udinv = udinv_v if r.ndim == 1 else udinv_v[:, None]
        y = r
        for _ in range(sweeps):
            y = r - (spmv(l_m, y) - y)
        x = udinv * y
        for _ in range(sweeps):
            x = x + udinv * (y - spmv(u_m, x))
        return x

    return ilu_apply


def _ilu0(pc, comm, op):
    (sweeps,) = pc.consts
    return _ilu_sweeps(pc.local, sweeps)


def _schwarz(pc, comm, op):
    """Restricted (ZERO) or classical (ADD) additive Schwarz: widen the
    residual to the overlapped subdomain [owned | overlap] with one
    exchange over the overlap plan, run the subdomain's fixed-sweep ILU(0)
    solves, then keep the owned part (ZERO) or export the overlap part
    back to its owners and add it (ADD)."""
    from .distmatrix import exchange, export_combine

    sweeps, combine, npl = pc.consts
    plan = pc.local["plan"]
    solve = _ilu_sweeps(pc.local, sweeps)

    def schwarz_apply(r):
        ghosts = exchange(r, plan, comm)
        z = solve(torch.cat([r, ghosts.to(r.dtype)]))
        return export_combine(z[:npl], z[npl:], plan, comm, combine)

    return schwarz_apply


def _amg(pc, comm, op):
    sweeps, omega, gamma, npl_c = pc.consts
    levels = pc.local["levels"]
    coarse_inv = pc.replicated["coarse_inv"]
    coarse_pos = pc.replicated["coarse_pos"]
    me = comm.index()

    def apply_dm(dm, v):
        return apply_local(dm.interior, dm.boundary, dm.plan, v, comm)

    def smooth(lvl, x, b):
        dinv = lvl["dinv"] if b.ndim == 1 else lvl["dinv"][:, None]
        for _ in range(sweeps):
            x = x + omega * dinv * (b - apply_dm(lvl["a"], x))
        return x

    def vcycle(k, b):
        if k == len(levels):
            # replicated dense coarse solve in logical (unpadded) space:
            # gather the padded chunks, compress through coarse_pos, one
            # (n_c, n_c) product, scatter back
            r_all = comm.all_gather(b)
            e_log = coarse_inv @ r_all[coarse_pos]
            e_all = torch.zeros_like(r_all)
            e_all[coarse_pos] = e_log.to(r_all.dtype)
            return e_all[me * npl_c:(me + 1) * npl_c]
        lvl = levels[k]
        x = smooth(lvl, torch.zeros_like(b), b)
        for _ in range(gamma):  # gamma=2 -> W-cycle
            r = b - apply_dm(lvl["a"], x)
            e_c = vcycle(k + 1, apply_dm(lvl["r"], r))
            x = x + apply_dm(lvl["p"], e_c)
        return smooth(lvl, x, b)

    return lambda r: vcycle(0, r)


def _amg_structured(pc, comm, op):
    """The fine level on the rank's z-slab (distributed stencil applies,
    local block sums); the coarse levels replicated after one tiled
    all_gather, cycled by the single-card hierarchy's own ``_cycle``. Each
    step repeats the single-card cycle's arithmetic, so a fine-level apply
    gives the single-card values on the rank's rows."""
    from ..precond.amg import (_structured_transfers, block_pair_dup,
                               block_pair_sum)

    amg, op_loc, depth, slab, cslab, block, om_t, n_c_pad = pc.consts
    sweeps, omega, gamma = amg.sweeps, amg.omega, amg.gamma
    local, rep = pc.local, pc.replicated
    plan, sel, valid = local["plan"], local["sel"], local["valid"]
    dinv_f = rep["dinv"]
    nrm = float(1.0 / np.sqrt(block[0] * block[1] * block[2]))
    n_lc = cslab[0] * cslab[1] * cslab[2]
    me = comm.index()
    inner = []
    for lvl, st in zip(amg.levels[1:], rep["inner"], strict=True):
        restrict, prolong = _structured_transfers(
            st["a"], lvl["dims"], lvl["n_c"], lvl["block"], lvl["omega"],
            st["dinv"])
        inner.append(dict(a=st["a"], dinv=st["dinv"], restrict=restrict,
                          prolong=prolong, cheb=None))
    levels = [None] + inner  # _cycle enters at level 1
    coarse_inv = rep["coarse_inv"]

    def a_fine(v):
        return apply_local_stencil(sel, valid, op_loc, depth, plan, v, comm)

    def dmul(r):
        return r * (dinv_f if r.ndim == 1 else dinv_f[:, None])

    def smooth(x, b):
        dinv = dinv_f if b.ndim == 1 else dinv_f[:, None]
        for i in range(sweeps):
            # from x = 0 the first sweep's A·x is zero: x = ω·D⁻¹·b exactly
            x = (omega * dinv * b if x is None
                 else x + omega * dinv * (b - a_fine(x)))
        return x

    def apply(r):
        x = smooth(None, r)
        for _ in range(gamma):
            res = r - a_fine(x)
            # restrict: P_tᵀ (res − ω·A D⁻¹ res), the block sum local
            s_loc = res - om_t * a_fine(dmul(res))
            rc = block_pair_sum(s_loc, slab, block) * nrm
            rc_g = comm.all_gather(rc)
            rc_p = rc_g.new_zeros((n_c_pad,) + tuple(rc_g.shape[1:]))
            rc_p[:rc_g.shape[0]] = rc_g
            e_g = amg._cycle(levels, coarse_inv, 1, rc_p)
            e_loc = e_g[me * n_lc:(me + 1) * n_lc]
            t = block_pair_dup(e_loc, cslab, block) * nrm
            x = x + (t - om_t * dmul(a_fine(t)))
        return smooth(x, r)

    return apply


def _chebyshev(pc, comm, op):
    dinv = pc.local["dinv"]
    lmax, lmin, degree = pc.consts

    def cheb(b):
        di = dinv if b.ndim == 1 else dinv[:, None]
        theta = (lmax + lmin) / 2
        delta = (lmax - lmin) / 2
        sigma1 = theta / delta
        rho = 1.0 / sigma1
        z = di * b
        d_vec = z / theta
        x = d_vec
        r = b
        for _ in range(degree - 1):
            r = r - op(d_vec)
            z = di * r
            rho_new = 1.0 / (2 * sigma1 - rho)
            d_vec = (rho_new * rho) * d_vec + (2 * rho_new / delta) * z
            x = x + d_vec
            rho = rho_new
        return x

    return cheb


def _cheb_fused(pc, comm, op):
    from ..ops.stencil_poly import stencil_poly_apply
    from .distmatrix import gather_extended

    stages, op_loc, npl, off = pc.consts
    local = pc.local
    plan, sel, valid = local["plan"], local["sel"], local["valid"]
    zb = tuple(int(z) for z in local["zb"].tolist())

    def cheb_fused(r):
        # one depth-s exchange feeds the whole fused sweep (the
        # communication-avoiding smoother)
        if r.ndim != 1:
            raise NotImplementedError("cheb_fused: single-vector apply only")
        ext = gather_extended(sel, valid, plan, r, comm)
        return stencil_poly_apply(op_loc, stages, ext,
                                  z_bounds=zb)[off:off + npl]

    return cheb_fused


_KINDS = {"identity": _identity, "jacobi": _jacobi, "ilu0": _ilu0,
          "amg": _amg, "amg_structured": _amg_structured,
          "chebyshev": _chebyshev, "cheb_fused": _cheb_fused,
          "schwarz": _schwarz}


def _padded_dinv(d: np.ndarray, rmap: Map, dtype) -> np.ndarray:
    """(P, n_local_pad) inverse diagonal, identity on padding rows."""
    dinv_g = 1.0 / np.where(d != 0, d, 1.0)
    stacked = rmap.to_padded(dinv_g)
    for s in range(rmap.n_shards):
        lo = s * rmap.n_local_pad + rmap.n_owned(s)
        stacked[lo:(s + 1) * rmap.n_local_pad] = 1.0
    return stacked.reshape(rmap.n_shards, rmap.n_local_pad).astype(
        _np_dtype(dtype))


def _np_dtype(dtype) -> np.dtype:
    return np.dtype(np.float32) if torch_dtype(dtype) == torch.float32 \
        else np.dtype(np.float64)


def dist_jacobi(a: CsrHost, rmap: Map, dtype=None) -> DistPrecond:
    """Row-partitioned inverse diagonal (the distributed Ifpack2
    RELAXATION)."""
    dtype = dtype or a.vals.dtype
    return DistPrecond(arrays={"dinv": _padded_dinv(
        a.diagonal().astype(np.float64), rmap, dtype)}, kind="jacobi")


def dist_chebyshev(a: CsrHost, rmap: Map, lmax: float,
                   lmin: float | None = None, degree: int = 4,
                   ratio: float = 30.0, dtype=None) -> DistPrecond:
    base = dist_jacobi(a, rmap, dtype)
    lmin = lmin if lmin is not None else lmax / ratio
    return DistPrecond(arrays=base.arrays, kind="chebyshev",
                       consts=(float(lmax), float(lmin), int(degree)))


def dist_cheb_fused(op, n_shards: int, degree: int = 4,
                    lmax: float | None = None,
                    lmin: float | None = None, ratio: float = 30.0,
                    boost: float = 1.1, eig_iters: int = 10,
                    device=None) -> DistPrecond:
    """Communication-avoiding fused Chebyshev smoother for a global
    matrix-free StencilOp over z-slabs: one depth-(degree·reach) exchange
    feeds the whole degree-d sweep through ``stencil_poly_apply`` (the
    ``poly_kernel`` on the card). Per-rank z-bounds keep the ghost planes
    past the global faces masked at every stage while interior cuts read
    real halo data. Without ``lmax``, the power estimate runs on
    ``device`` (``None``: the card)."""
    from ..ops.stencil_op import StencilOp
    from ..ops.stencil_poly import stencil_chebyshev_setup
    from .distmatrix import distribute_stencil, zslab_bounds

    if not isinstance(op, StencilOp):
        raise TypeError("dist_cheb_fused expects a global StencilOp")
    stages = stencil_chebyshev_setup(op, degree, lmax, lmin, ratio,
                                     boost, eig_iters, device=device)
    z_reach = max(max((abs(o[2]) for o in op.offsets), default=0), 1)
    depth = degree * z_reach
    ds = distribute_stencil(op, n_shards, depth=depth)
    pxy = op.dims[0] * op.dims[1]
    return DistPrecond(
        arrays={"plan": ds.plan, "sel": ds.sel, "valid": ds.valid,
                "zb": zslab_bounds(op, n_shards, depth)},
        kind="cheb_fused",
        consts=(stages, ds.op_local, ds.row_map.n_local_pad, depth * pxy))


def dist_ilu0(a: CsrHost, rmap: Map, sweeps: int = 6, dtype=None,
              fill_level: int = 0) -> DistPrecond:
    """Per-rank local ILU(k) (block-Jacobi ILU): each rank factors its
    LocalFilter (off-rank couplings dropped), the reference's parallel ILU
    composition (Ifpack2 LocalFilter + RILUK); the apply is the
    fixed-sweep Jacobi triangular solve. ``fill_level`` > 0 adds ILU(k)
    level fill to each local pattern."""
    from ..ops.formats import csr_to_ell
    from ..precond.ilu import ilu0_factor, iluk_augment

    dtype = dtype or a.vals.dtype
    npl = rmap.n_local_pad
    rows_all = a._rows()
    shards = []
    for s in range(rmap.n_shards):
        lo, hi = rmap.shard_lo(s), rmap.shard_hi(s)
        sl = slice(a.row_ptr[lo], a.row_ptr[hi])
        rs, cs, vs = rows_all[sl], a.cols[sl].astype(np.int64), a.vals[sl]
        keep = (cs >= lo) & (cs < hi)
        loc = CsrHost.from_coo(rs[keep] - lo, cs[keep] - lo, vs[keep],
                               (hi - lo, hi - lo))
        shards.append(ilu0_factor(iluk_augment(loc, fill_level)))
    kl = max(max(l.max_row_length() for l, _ in shards), 1)
    ku = max(max(u.max_row_length() for _, u in shards), 1)
    arrays = {k: [] for k in ("l_cols", "l_vals", "u_cols", "u_vals",
                              "udinv")}
    for l_m, u_m in shards:
        le = csr_to_ell(l_m, dtype=dtype, k=kl, n_rows_pad=npl, device="cpu")
        ue = csr_to_ell(u_m, dtype=dtype, k=ku, n_rows_pad=npl, device="cpu")
        arrays["l_cols"].append(le.cols.numpy())
        arrays["l_vals"].append(le.vals.numpy())
        arrays["u_cols"].append(ue.cols.numpy())
        arrays["u_vals"].append(ue.vals.numpy())
        du = u_m.diagonal().astype(np.float64)
        dv = np.ones(npl)
        dv[: len(du)] = 1.0 / np.where(du != 0, du, 1.0)
        arrays["udinv"].append(dv.astype(_np_dtype(dtype)))
    return DistPrecond(arrays={k: np.stack(v) for k, v in arrays.items()},
                       kind="ilu0", consts=(int(sweeps),))


def _overlap_rows(a: CsrHost, rmap: Map, overlap: int) -> list:
    """Each rank's overlap rows: ``overlap`` breadth-first layers of graph
    neighbours around its owned rows, owner-major and gid-sorted within an
    owner (the order of a halo plan's ghosts)."""
    n = a.shape[0]
    rows_all = a._rows()
    ghosts_of = []
    for s in range(rmap.n_shards):
        lo, hi = rmap.shard_lo(s), rmap.shard_hi(s)
        in_sub = np.zeros(n, dtype=bool)
        in_sub[lo:hi] = True
        frontier = np.arange(lo, hi)
        for _ in range(overlap):
            if not len(frontier):
                break
            sel = np.zeros(n, dtype=bool)
            sel[frontier] = True
            new = np.unique(a.cols[sel[rows_all]].astype(np.int64))
            new = new[~in_sub[new]]
            in_sub[new] = True
            frontier = new
        ovl = np.where(in_sub)[0]
        ovl = ovl[(ovl < lo) | (ovl >= hi)]
        ghosts_of.append(ovl[np.lexsort((ovl, rmap.owner_of(ovl)))])
    return ghosts_of


def dist_schwarz(a: CsrHost, rmap: Map, *, overlap: int = 1,
                 sweeps: int = 6, combine: str = "ZERO",
                 dtype=None) -> DistPrecond:
    """Distributed (restricted) additive Schwarz with ILU(0) subdomain
    solves (Ifpack2 AdditiveSchwarz over an OverlappingRowMatrix).

    Each rank's subdomain is its owned rows plus ``overlap`` layers of
    graph neighbours; a second halo plan gathers the residual on the
    overlap rows. The subdomain matrix (couplings outside the subdomain
    dropped, identity rows on the padding slots so the factorization stays
    regular) is factored by ILU(0) on the host, and L and U are packed as
    ELL at one width for every rank. The apply runs the fixed-sweep Jacobi
    triangular solves; ``combine`` 'ZERO' is restricted AS (the overlap
    part is dropped), 'ADD' classical AS (``export_combine`` adds it to
    its owners; any other CombineMode of ``export_combine`` works too)."""
    from ..ops.formats import csr_to_ell
    from ..precond.ilu import ilu0_factor
    from .distmatrix import _stack, build_halo_plans

    dtype = dtype or a.vals.dtype
    n_shards, npl, n = rmap.n_shards, rmap.n_local_pad, a.shape[0]
    rows_all = a._rows()
    ghosts_of = _overlap_rows(a, rmap, overlap)
    plans, _ = build_halo_plans(ghosts_of, rmap, n_shards)
    ntot = npl + plans[0].n_ghost_pad

    factors = []
    for s in range(n_shards):
        lo, hi = rmap.shard_lo(s), rmap.shard_hi(s)
        ovl = ghosts_of[s]
        # subdomain index of each global row (-1: outside the subdomain)
        lidx = np.full(n, -1, dtype=np.int64)
        lidx[lo:hi] = np.arange(hi - lo)
        lidx[ovl] = npl + np.arange(len(ovl))
        mask = lidx[rows_all] >= 0
        rs = lidx[rows_all[mask]]
        cs = lidx[a.cols[mask].astype(np.int64)]
        keep = cs >= 0
        present = np.zeros(ntot, dtype=bool)
        present[rs[keep]] = True
        pad_rows = np.where(~present)[0]
        sub = CsrHost.from_coo(
            np.concatenate([rs[keep], pad_rows]),
            np.concatenate([cs[keep], pad_rows]),
            np.concatenate([a.vals[mask][keep],
                            np.ones(len(pad_rows), dtype=a.vals.dtype)]),
            (ntot, ntot))
        factors.append(ilu0_factor(sub))

    kl = max(max(l_m.max_row_length() for l_m, _ in factors), 1)
    ku = max(max(u_m.max_row_length() for _, u_m in factors), 1)
    arrays = {k: [] for k in ("l_cols", "l_vals", "u_cols", "u_vals",
                              "udinv")}
    for l_m, u_m in factors:
        le = csr_to_ell(l_m, dtype=dtype, k=kl, n_rows_pad=ntot,
                        device="cpu")
        ue = csr_to_ell(u_m, dtype=dtype, k=ku, n_rows_pad=ntot,
                        device="cpu")
        arrays["l_cols"].append(le.cols.numpy())
        arrays["l_vals"].append(le.vals.numpy())
        arrays["u_cols"].append(ue.cols.numpy())
        arrays["u_vals"].append(ue.vals.numpy())
        du = u_m.diagonal().astype(np.float64)
        dv = np.ones(ntot)  # 1 on the padding slots
        dv[: len(du)] = 1.0 / np.where(du != 0, du, 1.0)
        arrays["udinv"].append(dv.astype(_np_dtype(dtype)))
    arrays = {k: np.stack(v) for k, v in arrays.items()}
    arrays["plan"] = _stack(plans)
    return DistPrecond(arrays=arrays, kind="schwarz",
                       consts=(int(sweeps), combine.upper(), npl))


def identity_precond() -> DistPrecond:
    return DistPrecond(arrays={}, kind="identity")


def _permute_rows(m: CsrHost, new_of_old: np.ndarray) -> CsrHost:
    return CsrHost.from_coo(new_of_old[m._rows()], m.cols.astype(np.int64),
                            m.vals, m.shape, sum_duplicates=False)


def _permute_cols(m: CsrHost, new_of_old: np.ndarray) -> CsrHost:
    return CsrHost.from_coo(m._rows(), new_of_old[m.cols.astype(np.int64)],
                            m.vals, m.shape, sum_duplicates=False)


def dist_amg(a: CsrHost, rmap: Map, *, max_levels: int = 10,
             coarse_max: int = 64, min_agg: int = 2,
             sa_damping: float = 4.0 / 3.0, sweeps: int = 2,
             omega: float = 0.8, cycle: str = "V",
             rebalance: bool = False, nullspace=None,
             n_equations: int = 1, dtype=None) -> DistPrecond:
    """Distributed smoothed-aggregation AMG.

    The set-up runs on the host (MueLu Hierarchy::Setup): aggregation,
    smoothed P, Galerkin coarse operators. Every level's A is a
    row-partitioned DistMatrix; P and R are rectangular DistMatrices whose
    halo plans live on the coarse and fine maps. The V/W-cycle runs in the
    ranks — smoothing, restriction and prolongation are halo-exchange
    applies — and the coarsest level is a replicated dense solve after
    one all_gather. ``rebalance`` re-partitions each coarse level with
    graph growing (MueLu's rebalancing)."""
    from ..precond.amg import build_hierarchy_host
    from .distmatrix import distribute, distribute_rect
    from .partition import (partition_greedy_graph,
                            partition_to_permutation, permute_csr)

    dtype = dtype or a.vals.dtype
    n_shards = rmap.n_shards
    assert rmap.n_global == a.shape[0]
    host_levels, a_coarse = build_hierarchy_host(
        a, max_levels, coarse_max, min_agg, sa_damping,
        nullspace=nullspace, n_equations=n_equations)

    if rebalance:
        relabeled = []
        for i, (a_l, p_l) in enumerate(host_levels):
            if i == 0:
                relabeled.append([a_l, p_l])
                continue
            perm = partition_to_permutation(
                partition_greedy_graph(a_l, n_shards))  # perm[new] = old
            inv = np.empty(a_l.shape[0], dtype=np.int64)
            inv[perm] = np.arange(a_l.shape[0])
            relabeled[i - 1][1] = _permute_cols(relabeled[i - 1][1], inv)
            relabeled.append([permute_csr(a_l, perm),
                              _permute_rows(p_l, inv)])
        if len(host_levels) > 1:
            # the coarsest operator's rows follow the last P's columns
            perm = partition_to_permutation(
                partition_greedy_graph(a_coarse, n_shards))
            inv = np.empty(a_coarse.shape[0], dtype=np.int64)
            inv[perm] = np.arange(a_coarse.shape[0])
            relabeled[-1][1] = _permute_cols(relabeled[-1][1], inv)
            a_coarse = permute_csr(a_coarse, perm)
        host_levels = [tuple(lv) for lv in relabeled]

    maps = [rmap]
    for (_, p_l) in host_levels:
        maps.append(Map.uniform(p_l.shape[1], n_shards))

    levels = []
    for i, (a_l, p_l) in enumerate(host_levels):
        fmap, cmap = maps[i], maps[i + 1]
        levels.append(dict(
            a=distribute(a_l, n_shards, dtype=dtype),
            p=distribute_rect(p_l, fmap, cmap, dtype=dtype),
            r=distribute_rect(p_l.transpose(), cmap, fmap, dtype=dtype),
            dinv=_padded_dinv(a_l.diagonal().astype(np.float64), fmap,
                              dtype)))

    cmap = maps[-1]
    gamma = 2 if cycle == "W" else 1
    return DistPrecond(
        arrays={"levels": levels}, kind="amg",
        consts=(int(sweeps), float(omega), gamma, cmap.n_local_pad),
        replicated=_coarse_inv_from_dense(a_coarse.to_dense(), cmap, dtype))


def _coarse_inv_from_dense(acc: np.ndarray, cmap: Map, dtype) -> dict:
    """Replicated dense pinv of the coarsest operator in logical space and
    the logical → padded position map used at apply time — the one home of
    the coarse-solve layout convention shared by dist_amg and
    dist_amg_blocks."""
    pos = np.zeros(cmap.n_global, np.int64)
    for s in range(cmap.n_shards):
        lo, hi = cmap.shard_lo(s), cmap.shard_hi(s)
        pos[lo:hi] = s * cmap.n_local_pad + np.arange(hi - lo)
    cinv = np.linalg.pinv(acc, rcond=1e-12)  # semidefinite-safe
    return {"coarse_inv": cinv.astype(_np_dtype(dtype)), "coarse_pos": pos}


def _coarse_dense_inv(a_c_blocks, cmap: Map, dtype) -> dict:
    """Coarse inverse from row-partitioned blocks (the only gather of the
    distributed set-up): assemble the dense accumulator, then the shared
    logical-space construction."""
    acc = np.zeros((cmap.n_global, cmap.n_global))
    for s in range(cmap.n_shards):
        blk = a_c_blocks[s]
        rows = blk._rows() + cmap.shard_lo(s)
        np.add.at(acc, (rows, blk.cols.astype(np.int64)), blk.vals)
    return _coarse_inv_from_dense(acc, cmap, dtype)


def dist_amg_blocks(blocks, rmap: Map, *, max_levels: int = 10,
                    coarse_max: int = 64, min_agg: int = 2,
                    sa_damping: float = 4.0 / 3.0, sweeps: int = 2,
                    omega: float = 0.8, cycle: str = "V",
                    dtype=None) -> DistPrecond:
    """Distributed smoothed-aggregation AMG with a distributed set-up:
    every step runs over row-partitioned blocks (uncoupled aggregation,
    distributed SpGEMM for the smoothed P, distributed RAP for every
    Galerkin level, ``dist_setup``), so no global matrix is assembled;
    only the ≤ ``coarse_max``-row coarsest operator is replicated. The
    cycle is :func:`dist_amg`'s."""
    from .dist_setup import build_dist_hierarchy, transpose_blocks
    from .distmatrix import distribute_blocks, distribute_rect_blocks

    dtype = dtype or blocks[0].vals.dtype
    n_shards = rmap.n_shards
    host_levels, a_c_blocks, cmap = build_dist_hierarchy(
        blocks, rmap, max_levels=max_levels, coarse_max=coarse_max,
        min_agg=min_agg, damping=sa_damping)

    levels = []
    for (a_bl, a_map, p_bl, c_map, d_bl) in host_levels:
        stacked = np.ones(a_map.n_global_pad)
        for s in range(n_shards):
            dinv_s = 1.0 / np.where(d_bl[s] != 0, d_bl[s], 1.0)
            lo = s * a_map.n_local_pad
            stacked[lo:lo + len(dinv_s)] = dinv_s
        levels.append(dict(
            a=distribute_blocks(a_bl, a_map, dtype=dtype),
            p=distribute_rect_blocks(p_bl, a_map, c_map, dtype=dtype),
            r=distribute_rect_blocks(transpose_blocks(p_bl, a_map, c_map),
                                     c_map, a_map, dtype=dtype),
            dinv=stacked.reshape(n_shards, a_map.n_local_pad).astype(
                _np_dtype(dtype))))
    gamma = 2 if cycle == "W" else 1
    return DistPrecond(
        arrays={"levels": levels}, kind="amg",
        consts=(int(sweeps), float(omega), gamma, cmap.n_local_pad),
        replicated=_coarse_dense_inv(a_c_blocks, cmap, dtype))


def dist_amg_structured(op, n_shards: int, *, sweeps: int = 2,
                        omega: float = 0.8, cycle: str = "V",
                        dtype=None, device=None,
                        **amg_params) -> DistPrecond:
    """Distributed structured-aggregation AMG for a global StencilOp over
    z-slabs — the single-card hierarchy (``SaAmg``, built on ``device``)
    made multi-rank:

    * level 0 is distributed: the DistStencil apply (plane halo exchange +
      the local stencil kernel) carries smoothing, residual and the
      smoothed-transfer applies; the tentative block sum and duplication
      are local (z aggregation pairs whole planes, so an even slab never
      crosses a cut);
    * levels 1+ are replicated: after the local restriction one tiled
      all_gather assembles the coarse residual and every rank runs the
      same coarse cycle, with no further collectives.

    Communication per V-cycle: 2·sweeps + 2 plane exchanges (the first
    pre-smoothing sweep starts from zero) and one all_gather. Needs nz
    divisible by n_shards with nz/n_shards even when z coarsens."""
    from ..ops.stencil_op import StencilOp
    from ..precond.amg import SaAmg
    from .distmatrix import distribute_stencil

    if not isinstance(op, StencilOp):
        raise TypeError("dist_amg_structured expects a global StencilOp")
    dtype = dtype or np.dtype(op.dtype)
    m = SaAmg(op, dict({"smoother: sweeps": sweeps,
                        "smoother: damping factor": omega,
                        "cycle type": cycle, "dtype": dtype},
                       **amg_params), device=device).compute()
    if not m.levels:
        raise ValueError(
            "dist_amg_structured: the hierarchy has no levels (problem "
            "size <= 'coarse: max size') — a distributed V-cycle is "
            "meaningless; solve directly or lower coarse: max size")
    fine = m.levels[0]
    nx, ny, nz = fine["dims"]
    bx, by, bz = fine["block"]
    nzl = nz // n_shards
    if nz % n_shards or (bz == 2 and nzl % 2):
        raise ValueError(
            f"dist_amg_structured: nz/n_shards = {nz}/{n_shards} must be a "
            "whole, even plane count so z-plane aggregation stays local")
    ds = distribute_stencil(op, n_shards)
    st = m.state()
    return DistPrecond(
        arrays={"plan": ds.plan, "sel": ds.sel, "valid": ds.valid},
        kind="amg_structured",
        consts=(m, ds.op_local, ds.depth, (nx, ny, nzl),
                (nx // bx, ny // by, nzl // bz), fine["block"],
                float(fine["omega"]), int(fine["n_c"])),
        replicated={"dinv": st["levels"][0]["dinv"],
                    "inner": st["levels"][1:],
                    "coarse_inv": st["coarse_inv"]})


# ---------------------------------------------------------------------------
# per-rank entry points
# ---------------------------------------------------------------------------


def dist_spmv(a, x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """y = A·x on this rank's padded local vector (1-D or (n, k)); ``a`` is
    a host DistMatrix / DistStencil or this rank's local part."""
    return local_op(_as_local(a, comm, x.device), comm)(x)


def dist_spmv_t(a, x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """y = Aᵀ·x (Tpetra's ``apply(X, Y, TRANS)``): local Aᵀ scatter into
    the extended column space and an Export-ADD of the ghost-column
    contributions over the reversed Import plan."""
    return local_op_t(_as_local(a, comm, x.device), comm)(x)


def dist_lsqr(a, b: torch.Tensor, x0: torch.Tensor | None = None, *,
              comm: Comm, **solver_kw) -> SolveResult:
    """Distributed LSQR (Golub–Kahan bidiagonalization needs A and Aᵀ):
    forward halo-exchange applies, reverse Export-ADD transpose applies
    and reductions over ``comm``."""
    from ..solvers.lsqr import lsqr

    al = _as_local(a, comm, b.device)
    return lsqr(local_op(al, comm), local_op_t(al, comm), b,
                x0=torch.zeros_like(b) if x0 is None else x0, comm=comm,
                **solver_kw)


def dist_solve(solver: Callable, a, b: torch.Tensor,
               x0: torch.Tensor | None = None, *, comm: Comm,
               prec: DistPrecond | Callable | None = None,
               **solver_kw) -> SolveResult:
    """Run any Krylov solver of ``trilinos_tpu_torch.solvers`` on this
    rank's padded local ``b`` (and ``x0``). ``a`` is a host DistMatrix /
    DistStencil or this rank's local part; ``prec`` a DistPrecond (made
    here for this rank) or a rank-local apply. Every apply, exchange and
    reduction of the solve runs in this rank against its peers."""
    al = _as_local(a, comm, b.device)
    op = local_op(al, comm)
    if prec is None or isinstance(prec, DistPrecond):
        m = (prec or identity_precond()).make(comm, op, b.device)
    else:
        m = prec
    return solver(op, b, x0=torch.zeros_like(b) if x0 is None else x0,
                  prec=m, comm=comm, **solver_kw)


def dist_sstep_gmres(op, b: torch.Tensor, *, comm: Comm, s: int = 4,
                     t_blocks: int = 8, max_restarts: int = 20,
                     rtol: float = 1e-8, atol: float = 0.0,
                     sigma: float | None = None, basis: str = "fused",
                     shifts=None, basis_dtype=None) -> SolveResult:
    """Communication-avoiding s-step GMRES on a global matrix-free
    StencilOp over z-slabs (CA-GMRES, Hoemmen/Demmel), on this rank's
    padded local ``b``.

    ``basis='fused'``: each block's matrix-powers basis
    W = [A q/σ … A^s q/σ^s] comes from ONE depth-(s·z-reach) exchange
    (``gather_extended``) feeding the all-outputs stencil polynomial
    (``stencil_powers_apply``: ``poly_kernel`` on the card, its plain
    version on the CPU) on the rank's extended slab, with the rank's
    z-bounds masking the ghost planes past the global faces at every stage
    while interior cuts read real halo data; a block step costs one
    exchange and four reductions (block CGS2 + CholQR2). A slab the
    kernel's plan refuses raises. ``basis='loop'``: the baseline, one
    depth-(z-reach) exchange an apply.

    ``sigma``: without it ‖A‖ is estimated once on the global operator in
    rank 0 (``estimate_opnorm``, the single-card driver's estimator) and
    broadcast, so every rank and the JAX package scale the basis alike.
    ``shifts``: Newton-basis shifts as for ``sstep_gmres``."""
    from ..ops.matvec import spmv
    from ..ops.stencil_op import StencilOp
    from ..ops.stencil_poly import monomial_stages, stencil_powers_apply
    from ..solvers.sstep_gmres import (estimate_opnorm, newton_basis_stages,
                                       sstep_gmres)
    from .distmatrix import distribute_stencil, gather_extended, zslab_bounds

    if not isinstance(op, StencilOp):
        raise TypeError("dist_sstep_gmres expects a global StencilOp")
    if basis not in ("fused", "loop"):
        raise ValueError(f"basis is 'fused' or 'loop', not {basis!r}")
    p, me = comm.size, comm.index()
    if sigma is None:
        sig = (estimate_opnorm(lambda v: spmv(op, v), op.n_rows_pad,
                               b.dtype, device=b.device) if me == 0 else 0.0)
        # rank 0's value plus zeros: exact on every rank
        sigma = float(comm.psum(torch.tensor(sig, dtype=torch.float64,
                                             device=b.device)))
    z_reach = max(max((abs(o[2]) for o in op.offsets), default=0), 1)
    # the loop baseline exchanges once an apply, so single-apply depth
    depth = s * z_reach if basis == "fused" else z_reach
    al = distribute_stencil(op, p, depth=depth).local(me, b.device)
    if shifts is not None:
        stages = tuple((a, bt, g, 0.0)
                       for a, bt, g in newton_basis_stages(shifts, sigma))
    else:
        stages = monomial_stages(s, sigma)
    zb = tuple(int(z) for z in zslab_bounds(op, p, depth)[me])
    off = depth * op.dims[0] * op.dims[1]
    npl = al.row_map.n_local_pad

    def powers_fn(q, sig):
        ext = gather_extended(al.sel, al.valid, al.plan, q, comm)
        u = stencil_powers_apply(al.op_local, stages, ext, z_bounds=zb)
        return u[:, off:off + npl].T  # (npl, s)

    return sstep_gmres(
        local_op(al, comm), b, s=s, t_blocks=t_blocks,
        max_restarts=max_restarts, rtol=rtol, atol=atol, sigma=sigma,
        comm=comm, shifts=shifts,
        powers_fn=powers_fn if basis == "fused" else None,
        basis_impl="loop", basis_dtype=basis_dtype)


# ---------------------------------------------------------------------------
# the operator as the eigensolvers see it (the Anasazi-over-Tpetra role)
# ---------------------------------------------------------------------------


def global_operator(a, comm: Comm, device=None) -> Callable:
    """The distributed apply y = A·x as a solver sees it (Tpetra's
    ``Operator::apply``), for a host DistMatrix / DistStencil or this
    rank's local part; ``device`` (``None``: the card) places a host
    matrix's part.

    The JAX package's "global view" takes and returns whole GSPMD-sharded
    arrays from one program over the mesh; here the group of ranks is that
    view, and each rank's closure takes and returns its padded local
    block, 1-D or (n, k): a solver run in every rank with ``comm`` is the
    distributed solver."""
    return local_op(_as_local(a, comm, device), comm)


def global_precond(prec: DistPrecond, a, comm: Comm,
                   device=None) -> Callable:
    """The distributed apply of ``prec`` over the operator of ``a`` (see
    :func:`global_operator`): this rank's closure on its padded local
    block."""
    al = _as_local(a, comm, device)
    return prec.make(comm, local_op(al, comm), al.device)


_EIG_V0_WIDTH = {
    # solver name -> start-block width (0 = a single 1-D start vector)
    "lobpcg": lambda nev, kw: nev,
    "tracemin": lambda nev, kw: kw.get("block") or nev + 2,
    "rtr": lambda nev, kw: kw.get("block") or nev,
    "block_davidson": lambda nev, kw: kw.get("nb") or nev,
    "generalized_davidson": lambda nev, kw: kw.get("nb") or nev,
    "block_krylov_schur": lambda nev, kw: kw.get("nb") or 1,
    "lanczos_eigs": lambda nev, kw: 0,
    "arnoldi": lambda nev, kw: 0,
    "power_method": lambda nev, kw: 0,
}

# the solvers whose ``m`` is the mass operator (elsewhere ``m`` may mean
# something else, such as lanczos_eigs's basis length)
_M_IS_MASS = ("lobpcg", "tracemin", "block_davidson",
              "generalized_davidson", "rtr")


def dist_eigsolve(eigsolver: Callable, a, nev: int, *, comm: Comm,
                  v0: np.ndarray | None = None,
                  prec: DistPrecond | Callable | None = None, seed: int = 7,
                  mass_matrix=None, device=None, **kw):
    """Run any eigensolver of ``trilinos_tpu_torch.eigen`` on a distributed
    operator, in every rank of the group (Anasazi over Tpetra: each SolMgr
    is MPI-distributed through MultiVecTraits).

    ``a`` is a host DistMatrix / DistStencil or this rank's local part
    (``device``, ``None`` meaning the card, places a host matrix's part).
    The solver gets :func:`global_operator`'s closure, ``comm`` (so every
    Gram matrix, norm and host decision reads values reduced over the
    group, the same on every rank), the rank's ``n_local_pad`` as ``n``
    (the solvers reduce it where they need the global size) and the rank's
    chunk of the padded global start block as ``v0``.

    ``v0`` is an unpadded host array ((n,) or (n, w)); without it the
    start is ``default_rng(seed)`` normals as wide as the solver's own
    default. Pad rows are zero, so the zero-pad subspace stays invariant.
    ``prec``: a DistPrecond (made here over the operator) or a rank-local
    apply. ``mass_matrix``: the M of the pencil A x = λ M x, bound as
    ``mass`` (block Krylov-Schur) or ``m`` (the solvers of
    ``_M_IS_MASS``); any other solver raises. Returns the solver's result
    with the eigenvectors as this rank's padded local rows."""
    import inspect

    al = _as_local(a, comm, device)
    dev, rmap = al.device, al.row_map
    dtype = torch_dtype(kw.get("dtype", torch.float64))
    params = list(inspect.signature(eigsolver).parameters)
    if "dtype" not in params:  # lobpcg and lanczos take v0's dtype
        kw.pop("dtype", None)
    name = getattr(eigsolver, "__name__", "")
    width = _EIG_V0_WIDTH.get(name, lambda nev, kw: nev)(nev, kw)
    if v0 is None:
        rng = np.random.default_rng(seed)
        v0 = rng.standard_normal((rmap.n_global,) if width == 0
                                 else (rmap.n_global, width))
    v0l = torch.from_numpy(rmap.local_chunk(rmap.to_padded(
        np.asarray(v0, dtype=_np_dtype(dtype))), comm.index()).copy()).to(dev)

    op = local_op(al, comm)
    if prec is not None:
        kw["prec"] = (prec.make(comm, op, dev)
                      if isinstance(prec, DistPrecond) else prec)
    if mass_matrix is not None:
        mop = global_operator(mass_matrix, comm, dev)
        if "mass" in params:
            kw["mass"] = mop
        elif name in _M_IS_MASS:
            kw["m"] = mop
        else:
            raise ValueError(
                f"{name or eigsolver!r} does not support a mass matrix; "
                "use lobpcg, tracemin, block_davidson, "
                "generalized_davidson, rtr, or block_krylov_schur for "
                "generalized pencils")
    kw["comm"] = comm
    if len(params) > 1 and params[1] == "n":
        # (op, n, nev, ..., v0=): Davidson, Krylov-Schur, TraceMin, RTR
        return eigsolver(op, rmap.n_local_pad, nev, v0=v0l, **kw)
    if "nev" in params:  # lanczos_eigs(op, v0, nev, ...)
        return eigsolver(op, v0l, nev, **kw)
    return eigsolver(op, v0l, **kw)  # lobpcg, power_method, arnoldi
