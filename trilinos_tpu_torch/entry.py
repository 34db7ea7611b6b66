"""The port's paths: the Galeri Laplace3D stencil and 3-D elasticity.

``entry()``: structured-AMG-preconditioned CG on a matrix-free Galeri
Laplace3D stencil, the twin of ``__graft_entry__.entry()``. It builds the
operator, the hierarchy and the right-hand side (same defaults and seed as
the JAX package's entry: 16³, float32, ``default_rng(0)``) and returns
``(step, (b, state))``; ``step(b, state)`` runs the solve and returns the
:class:`SolveResult` (the JAX step returns its ``.x``).

``block_entry()``: the same operator and hierarchy under block GMRES with
CGS2 projection and CholQR2 normalisation, nrhs right-hand sides
(BASELINE config 5: "Block-GMRES nrhs=16 with CGS2 ortho on a 10M-row
stencil matrix").

``cheb_entry()``: AMG-PCG as ``entry()`` with the Chebyshev smoother on
the fine level (degree sweeps+1 = 3, one stencil polynomial apply).

``sstep_entry()``: unpreconditioned s-step GMRES with the matrix-powers
basis, the JAX package's bench configuration (s = 4, t_blocks = 8,
max_restarts = 4, rtol = 0, σ = 12: five cycles of 32 basis vectors);
``step(b)``.

``fused_cg_entry()``: unpreconditioned CG with one fused iteration kernel
per iteration (rtol 1e-5, maxiter 2000 by default); ``step(b)``.

``gmres_entry()``: GMRES(30) with CGS2 on the same matrix-free operator,
the JAX bench's ``bench_gmres`` solver; right-preconditioned by the
structured hierarchy when one is given as ``amg=``, with an optional
narrower ``basis_dtype``; ``step(b, state)`` (state None when
unpreconditioned).

``bsr_gmres_entry()``: BASELINE config 2, "Laplace3D 64³ BSR,
Jacobi-preconditioned GMRES(30), multi-vector SpMM nrhs=4": Galeri
Laplace3D stored as a BsrMatrix with b = 4, right-preconditioned by
``Relaxation`` (Jacobi), pseudo-block GMRES(30) on nrhs = 4 seed-1 normals
(the JAX package's BASELINE test), float64, rtol 1e-8, maxiter 1000;
``step(b)``.
``solver`` picks the GMRES variant on the same problem ("gmres",
"fgmres", "single_reduce" or "pipeline"); ``history=True`` (gmres and
fgmres) returns each column's residual trace, whose last finite entry is
that column's iteration count.

``elasticity_entry()``: CG preconditioned by the block-structured
null-space AMG (``BlockStructuredAmg``: rigid-body modes, BDIA levels) on
Galeri ``elasticity3d`` with E = 1, the JAX package's bench configuration
(``"coarse: max size"`` 3000, rtol 1e-5, maxiter 100); ``step(b, state)``.

``bdia_cg_entry()``: unpreconditioned CG on the same operator stored as a
BdiaMatrix, run in plane layout through ``bdia_plane_solver_op`` for a
fixed ``iters`` iterations (rtol 0), the JAX bench's plane-layout solve;
``step(b)`` returns the result with x back in the interleaved layout. An
already packed operator may be passed as ``a=``; grid, dtype and device
then come from it.

``factory_entry(name)``: the named solver kind through the factory,
``create_solver(name, params).solve(LinearProblem(...))``, on the
matrix-free Laplace3D stencil, preconditioned by the structured hierarchy
(``apply_state``); LSQR takes no preconditioner and gets the transposed
stencil as ``op_t``. One manager serves every call of ``step(b, state)``
(state None for LSQR), so the recycling kinds (GCRODR, Block GCRODR, RCG)
reuse the previous solve's space; it is ``step.manager``. ``nrhs`` gives
a block of right-hand sides.

``pipelined_cg_entry()``: BASELINE config 4 on one card, "Laplace3D 128³,
pipelined CG": Galeri Laplace3D stored through ``choose_format`` (DIA, 7
diagonals), float64, unpreconditioned ``cg_pipeline`` at rtol 1e-8 on a
seed-3 normal right-hand side (the JAX package's BASELINE test);
``step(b)``, with the stored matrix as ``step.matrix``.

``build_entry()``: the Stratimikos path. ``build()`` takes the solver and
preconditioner names and their parameter lists and returns a manager and
a computed preconditioner for Galeri Laplace3D (host CSR, float32); the
operator is the same matrix stored as DIA. ``params`` are the solver's and
``prec_params`` the preconditioner's (default: CHEBYSHEV degree 3, any
other preconditioner its defaults); other keywords go to the
preconditioner's constructor (HIPTMAIR's ``aux_op``). An already
assembled host matrix may be passed as ``a=`` and its stored form (any
format) as ``dia=``; ``step(b)``, with ``step.manager`` and
``step.preconditioner``.

``mm_block_gmres_entry()``: BASELINE config 3, "MatrixMarket suite (e.g.
bcsstk, sherman) block-GMRES with ILU(0) + DGKS ortho". The matrix is a
given file, ``matrix_file=`` (Matrix Market, read with ``read_sparse``, or
Harwell-Boeing, read with ``read_hb``, chosen by the file's first line;
the file is only read), or else a generated nonsymmetric one: Galeri
``recirc2d(nx, nx)`` (default diffusion) written to a Matrix Market file
with ``write_sparse`` and read back with ``read_sparse`` (the native
reader), the file at ``path`` (default: a temporary directory, removed
after the read). Either way it is stored as ELL, preconditioned by
``Ilu0`` with 20 Jacobi sweeps a factor (its factors DIA), and solved by
block GMRES with DGKS projection on nrhs = 2 seed-2 normals, float64,
``num_blocks=60``, ``max_restarts=20``, rtol 1e-8 (the JAX package's
BASELINE test); ``step(b)``, with the matrix read as ``step.matrix``, its
ELL form as ``step.operator`` and the preconditioner as
``step.preconditioner``.

``komplex_entry()``: a complex solve through its equivalent real form
(Komplex): the complex shifted Laplacian Galeri ``laplace2d(nx, nx)`` +
i·``shift``·I is written as a complex Matrix Market file (to ``path``, or
a temporary directory) and read back with ``read_sparse`` (complex files
take the Python parser), then ``step(bz)`` runs ``solve_complex`` on it
with GMRES(30) at rtol 1e-8 right-preconditioned by ``RILUK`` (ILU(0),
fixed-sweep applies) on the 2n × 2n real form, set-up included, and
returns ``(z, result)``; ``bz`` is a seed-5 complex normal (host numpy),
the complex matrix is ``step.matrix`` and the solve's parameter list
``step.params``.

``uncoupled_amg_entry()``: CG at rtol 1e-5 preconditioned by the uncoupled
smoothed-aggregation hierarchy (``SaAmg`` with "aggregation: type"
"uncoupled") of a stored Galeri Laplace3D host CSR, float32: the fine
level packs as DIA and the coarse levels as ELL, P and Pᵀ as ELL. The CG
operator is the hierarchy's stored fine level; ``step(b, state)`` as
``entry()``.

``eigen_entry(name)``: the named eigensolver kind through the Anasazi
factory, ``create_eigensolver(name, params).solve(EigenProblem(...))``, on
the matrix-free Galeri Laplace3D stencil (float64 by default), ``nev``
eigenpairs; preconditioned by the structured hierarchy's V-cycle when one
is given as ``amg=`` (its grid, dtype and device then), with ``mass=`` an
SPD mass operator (a stored or stencil matrix, or a callable) for the
pencil A x = λ M x. The start block is ``default_rng(7)`` normals, as wide
as the kind's own default start (1-D for LANCZOS and POWER), zero in the
pad rows, whose stencil rows map y = x and would otherwise add the
eigenvalue 1; ``step(v0, state)`` returns the kind's result, with the
manager as ``step.manager`` and the operator as ``step.operator``.

``dist_pipelined_cg_entry()``: BASELINE config 4 row-partitioned, the
distributed twin of ``pipelined_cg_entry``, run in each rank of a
``torch.distributed`` group (``comm``, a ``ProcessComm`` of the default
group when not given; ``n_ranks`` must be its size): Galeri Laplace3D
stored, ``distribute(…, fmt="auto")`` (DIA interiors with 7 diagonals),
the halo-overlap ``apply_local``, ``cg_pipeline`` with ``dist_jacobi``,
rtol 1e-8, float64, on the seed-3 right-hand side; ``step(b)`` on the
rank's padded local ``b``, with the rank's matrix as ``step.matrix`` and
the row map as ``step.row_map``.

``dist_amg_entry()``: structured-AMG-preconditioned CG on the z-slab
``DistStencil`` of the matrix-free Laplace3D (``dist_amg_structured``),
with ``entry()``'s defaults and seed-0 right-hand side, in each rank as
above; ``step(b)``, with the rank's ``LocalStencil`` as ``step.operator``,
``step.row_map`` and the ``DistPrecond`` as ``step.preconditioner``.

``dist_sstep_entry()``: the distributed twin of ``sstep_entry`` in each
rank as above: ``dist_sstep_gmres`` on the z-slab ``DistStencil`` of the
matrix-free Laplace3D with the same fixed work (s = 4, t_blocks = 8,
max_restarts = 4, rtol = 0, σ = 12, float32) and the same seed-0
right-hand side; each block's basis is one depth-4 exchange and one
``stencil_powers_apply`` on the rank's extended slab; ``step(b)``, with
the global ``StencilOp`` as ``step.operator`` and ``step.row_map``.

``dist_eigen_entry()``: the distributed twin of ``eigen_entry("LOBPCG",
amg=...)``: LOBPCG (which SM, tol 1e-8, maxiter 200) for the ``nev``
smallest eigenpairs of the z-slab ``DistStencil`` in float64,
preconditioned by ``dist_amg_structured``, through ``dist_eigsolve`` from
the seed-7 start block; ``step()``, with the rank's ``LocalStencil`` as
``step.operator``, ``step.row_map`` and the ``DistPrecond`` as
``step.preconditioner``.

``dist_schwarz_entry()``: BASELINE config 4's stored Laplace3D,
row-partitioned as in ``dist_pipelined_cg_entry`` (DIA interiors), solved
by GMRES(30) at rtol 1e-8 (at most 1000 iterations) right-preconditioned
by ``dist_schwarz`` (overlap 1, ILU(0) subdomains, restricted:
``combine="ZERO"``), float64, on the seed-3 right-hand side;
``step(b)``, with ``step.matrix``, ``step.row_map`` and
``step.preconditioner``.

``dist_md_entry()``: Laplace3D on a field split over a rank grid (Domi's
MDMap/MDVector, ``parallel/mdarray.py``): the global field of ``dims``
has its axis i split over axis i of a ``grid`` of ranks (``comm``'s
group, made a ``ProcessGrid`` with axes x, y, z when it is not one
already); CG at rtol ``MD_RTOL`` through ``md_solve``, preconditioned by
``md_poly_local`` with degree-3 Chebyshev stages on D⁻¹A (λmax bound 2,
λmin = λmax / 30), one depth-3 exchange an apply; the operator and every
stage apply the 7-point stencil to the padded block through
``stencil_spmv`` (``stencil_kernel`` on the card); float32 by default,
on the seed-0 normals over the global field. ``step(b)`` on the rank's
block, with ``step.grid``, ``step.mdmap`` and the block apply as
``step.local_fn``.

Every entry takes ``device`` (``None`` means the CUDA card and raises
without one); the hierarchy paths also take an already-built hierarchy as
``amg=`` so one hierarchy can serve several paths, and their grid, dtype
and device then come from it. Right-hand sides are seed-0 normals with
zero pad rows.
"""
from __future__ import annotations

import dataclasses
import gzip
import pathlib
import tempfile

import numpy as np
import torch

from .device import resolve_device, torch_dtype
from .eigen import EigenProblem, create_eigensolver
from .galeri import (elasticity3d, laplace2d, laplace3d, recirc2d,
                     rigid_body_modes)
from .io import read_hb, read_sparse, write_sparse
from .ops.bdia_spmv import bdia_plane_solver_op
from .ops.formats import (CsrHost, choose_format, csr_to_bdia, csr_to_bsr,
                          csr_to_ell)
from .ops.komplex import solve_complex
from .ops.matvec import spmv
from .precond import BlockStructuredAmg, Ilu0, Relaxation, SaAmg
from .solvers import (LinearProblem, block_gmres, build, cg, cg_fused,
                      cg_pipeline, create_solver, fgmres, gmres,
                      gmres_pipeline, gmres_single_reduce, sstep_gmres)


def _hierarchy(dims, dtype, device, amg, smoother="jacobi"):
    """(operator, SaAmg) of Laplace3D on ``dims``, or those of ``amg``."""
    if amg is None:
        op = laplace3d(*dims, dtype=dtype, fmt="stencil")
        amg = SaAmg(op, {"dtype": dtype, "smoother: type": smoother},
                    device=resolve_device(device)).compute()
    elif amg.params["smoother: type"] != smoother:
        raise ValueError(f"this path needs a hierarchy with the {smoother} "
                         f"smoother, got {amg.params['smoother: type']}")
    return amg.fine_op, amg


def _rhs(op, device, dtype, nrhs=None):
    """Seed-0 normal right-hand side(s) on ``device`` in ``dtype``, zero in
    the pad rows."""
    n, npad = op.n_rows, op.n_rows_pad
    tail = () if nrhs is None else (nrhs,)
    host = np.zeros((npad,) + tail, np.float64)
    host[:n] = np.random.default_rng(0).standard_normal((n,) + tail)
    return torch.from_numpy(host).to(device, dtype)


def _amg_cg(op, m):
    def step(b_vec: torch.Tensor, st: dict):
        return cg(lambda v: spmv(op, v), b_vec,
                  prec=lambda v: m.apply_state(st, v),
                  rtol=1e-5, maxiter=50)

    return step, (_rhs(op, m.device, m.dtype), m.state())


def entry(dims=(16, 16, 16), dtype=np.float32, device=None, amg=None):
    return _amg_cg(*_hierarchy(dims, dtype, device, amg))


def cheb_entry(dims=(16, 16, 16), dtype=np.float32, device=None, amg=None):
    return _amg_cg(*_hierarchy(dims, dtype, device, amg, "chebyshev"))


def block_entry(dims=(16, 16, 16), nrhs=16, dtype=np.float32, device=None,
                amg=None):
    op, m = _hierarchy(dims, dtype, device, amg)

    def step(b_mv: torch.Tensor, st: dict):
        return block_gmres(lambda v: spmv(op, v), b_mv,
                           prec=lambda v: m.apply_state(st, v),
                           num_blocks=25, max_restarts=10, rtol=1e-5,
                           ortho="CGS2")

    return step, (_rhs(op, m.device, m.dtype, nrhs), m.state())


def sstep_entry(dims=(16, 16, 16), dtype=np.float32, device=None):
    op = laplace3d(*dims, dtype=dtype, fmt="stencil")

    def step(b_vec: torch.Tensor):
        return sstep_gmres(op, b_vec, s=4, t_blocks=8, max_restarts=4,
                           rtol=0.0, sigma=12.0)

    return step, (_rhs(op, resolve_device(device), torch_dtype(dtype)),)


def fused_cg_entry(dims=(16, 16, 16), dtype=np.float32, device=None,
                   rtol=1e-5, maxiter=2000):
    op = laplace3d(*dims, dtype=dtype, fmt="stencil")

    def step(b_vec: torch.Tensor):
        return cg_fused(op, b_vec, rtol=rtol, maxiter=maxiter)

    return step, (_rhs(op, resolve_device(device), torch_dtype(dtype)),)


def gmres_entry(dims=(16, 16, 16), dtype=np.float32, device=None, amg=None,
                basis_dtype=None, rtol=1e-5, maxiter=1000):
    if amg is None:
        op = laplace3d(*dims, dtype=dtype, fmt="stencil")
        dev, m, st = resolve_device(device), None, None
    else:
        op, m = _hierarchy(dims, dtype, device, amg)
        dev, st = m.device, m.state()

    def step(b_vec: torch.Tensor, st):
        prec = None if st is None else (lambda v: m.apply_state(st, v))
        return gmres(lambda v: spmv(op, v), b_vec, prec=prec, restart=30,
                     rtol=rtol, maxiter=maxiter, ortho="CGS2",
                     basis_dtype=basis_dtype)

    return step, (_rhs(op, dev, torch_dtype(dtype)), st)


_GMRES_VARIANTS = {"gmres": gmres, "fgmres": fgmres,
                   "single_reduce": gmres_single_reduce,
                   "pipeline": gmres_pipeline}


def bsr_gmres_entry(dims=(64, 64, 64), device=None, solver="gmres",
                    history=False):
    solve = _GMRES_VARIANTS[solver]
    extra = {"history": True} if history else {}
    a = laplace3d(*dims)
    dev = resolve_device(device)
    bsr = csr_to_bsr(a, 4, device=dev)
    m = Relaxation(a, device=dev).compute()
    npad, nd = bsr.n_rows_pad, m.dinv.shape[0]

    def prec(v):
        out = m(v[:nd])
        return torch.nn.functional.pad(
            out, (0, 0) * (out.ndim - 1) + (0, npad - out.shape[0]))

    def step(b_mv: torch.Tensor):
        return solve(lambda v: spmv(bsr, v), b_mv, prec=prec, restart=30,
                     rtol=1e-8, maxiter=1000, **extra)

    host = np.zeros((npad, 4))
    host[:a.shape[0]] = np.random.default_rng(1).standard_normal(
        (a.shape[0], 4))
    return step, (torch.from_numpy(host).to(dev),)


def elasticity_entry(dims=(8, 8, 8), dtype=np.float32, device=None,
                     amg=None):
    if amg is None:
        a = elasticity3d(*dims, e_mod=1.0, dtype=dtype)
        amg = BlockStructuredAmg(
            a, {"dtype": dtype, "coarse: max size": 3000}, node_dims=dims,
            nullspace=rigid_body_modes(*dims), n_equations=3,
            device=resolve_device(device)).compute()
    op, m = amg.fine_op, amg

    def step(b_vec: torch.Tensor, st: dict):
        return cg(lambda v: spmv(op, v), b_vec,
                  prec=lambda v: m.apply_state(st, v), rtol=1e-5,
                  maxiter=100)

    return step, (_rhs(op, m.device, m.dtype), m.state())


def bdia_cg_entry(dims=(8, 8, 8), iters=400, dtype=np.float32, device=None,
                  a=None):
    if a is None:
        a = csr_to_bdia(elasticity3d(*dims, e_mod=1.0, dtype=dtype), 3,
                        dtype=dtype, device=resolve_device(device))
    op, pack, unpack = bdia_plane_solver_op(a)

    def step(b_vec: torch.Tensor):
        res = cg(op, pack(b_vec), rtol=0.0, maxiter=iters)
        return dataclasses.replace(res, x=unpack(res.x))

    return step, (_rhs(a, a.data.device, a.dtype),)


def factory_entry(name, params=None, dims=(16, 16, 16), nrhs=None,
                  dtype=np.float32, device=None, amg=None):
    mgr = create_solver(name, params)
    if mgr.kind == "lsqr":
        if amg is None:
            op, dev = laplace3d(*dims, dtype=dtype, fmt="stencil"), \
                resolve_device(device)
        else:
            op, dev = amg.fine_op, amg.device
        m, st, dt = None, None, torch_dtype(dtype if amg is None
                                            else amg.dtype)
    else:
        op, m = _hierarchy(dims, dtype, device, amg)
        dev, st, dt = m.device, m.state(), m.dtype

    def step(b_vec: torch.Tensor, st):
        problem = LinearProblem(lambda v: spmv(op, v), b_vec)
        if st is None:
            problem.op_t = lambda v: spmv(op, v, transpose=True)
        else:
            problem.right_prec = lambda v: m.apply_state(st, v)
        return mgr.solve(problem)

    step.manager = mgr
    return step, (_rhs(op, dev, dt, nrhs), st)


def pipelined_cg_entry(dims=(128, 128, 128), device=None):
    a = laplace3d(*dims)
    dia = choose_format(a, device=resolve_device(device))
    n, npad = a.shape[0], dia.n_rows_pad

    def step(b_vec: torch.Tensor):
        return cg_pipeline(lambda v: spmv(dia, v), b_vec, rtol=1e-8)

    step.matrix = dia
    host = np.zeros(npad)
    host[:n] = np.random.default_rng(3).standard_normal(n)
    return step, (torch.from_numpy(host).to(dia.data.device),)


def _rank_comm(comm, n_ranks):
    """The rank's comm (the default group's) and its size, checked against
    ``n_ranks``."""
    from .parallel.comm import ProcessComm

    comm = comm or ProcessComm()
    if n_ranks is not None and n_ranks != comm.size:
        raise ValueError(f"n_ranks={n_ranks} but the group has {comm.size} "
                         f"ranks")
    return comm


def _local_rhs(rmap, seed, rank, device, dtype=torch.float64):
    """The rank's padded chunk of seed-``seed`` normals over the global
    rows."""
    host = np.random.default_rng(seed).standard_normal(rmap.n_global)
    return torch.from_numpy(rmap.local_chunk(rmap.to_padded(host),
                                             rank).copy()).to(device, dtype)


def dist_pipelined_cg_entry(dims=(128, 128, 128), n_ranks=None, comm=None,
                            device=None):
    from .parallel.distmatrix import distribute
    from .parallel.driver import dist_jacobi, dist_solve, local_op

    comm = _rank_comm(comm, n_ranks)
    dev = resolve_device(device)
    a = laplace3d(*dims)
    dm = distribute(a, comm.size, fmt="auto")
    al = dm.local(comm.index(), dev)
    m = dist_jacobi(a, dm.row_map).make(comm, local_op(al, comm), dev)

    def step(b_vec: torch.Tensor):
        return dist_solve(cg_pipeline, al, b_vec, comm=comm, prec=m,
                          rtol=1e-8)

    step.matrix, step.row_map = al, dm.row_map
    return step, (_local_rhs(dm.row_map, 3, comm.index(), dev),)


def dist_amg_entry(dims=(16, 16, 16), n_ranks=None, comm=None,
                   dtype=np.float32, device=None):
    from .parallel.distmatrix import distribute_stencil
    from .parallel.driver import dist_amg_structured, dist_solve, local_op

    comm = _rank_comm(comm, n_ranks)
    dev = resolve_device(device)
    op = laplace3d(*dims, dtype=dtype, fmt="stencil")
    pc = dist_amg_structured(op, comm.size, dtype=dtype, device=dev)
    al = distribute_stencil(op, comm.size).local(comm.index(), dev)
    m = pc.make(comm, local_op(al, comm), dev)

    def step(b_vec: torch.Tensor):
        return dist_solve(cg, al, b_vec, comm=comm, prec=m, rtol=1e-5,
                          maxiter=50)

    step.operator, step.row_map, step.preconditioner = al, al.row_map, pc
    return step, (_local_rhs(al.row_map, 0, comm.index(), dev,
                             torch_dtype(dtype)),)


def dist_sstep_entry(dims=(256, 256, 256), n_ranks=None, comm=None,
                     dtype=np.float32, device=None):
    from .parallel.driver import dist_sstep_gmres
    from .parallel.map import Map

    comm = _rank_comm(comm, n_ranks)
    dev = resolve_device(device)
    op = laplace3d(*dims, dtype=dtype, fmt="stencil")

    def step(b_vec: torch.Tensor):
        return dist_sstep_gmres(op, b_vec, comm=comm, s=4, t_blocks=8,
                                max_restarts=4, rtol=0.0, sigma=12.0)

    rmap = Map.uniform(op.n_rows, comm.size)
    step.operator, step.row_map = op, rmap
    return step, (_local_rhs(rmap, 0, comm.index(), dev,
                             torch_dtype(dtype)),)


def dist_eigen_entry(dims=(256, 256, 256), nev=4, n_ranks=None, comm=None,
                     dtype=np.float64, device=None):
    from .eigen import lobpcg
    from .parallel.distmatrix import distribute_stencil
    from .parallel.driver import dist_amg_structured, dist_eigsolve, local_op

    comm = _rank_comm(comm, n_ranks)
    dev = resolve_device(device)
    op = laplace3d(*dims, dtype=dtype, fmt="stencil")
    pc = dist_amg_structured(op, comm.size, dtype=dtype, device=dev)
    al = distribute_stencil(op, comm.size).local(comm.index(), dev)
    m = pc.make(comm, local_op(al, comm), dev)

    def step():
        return dist_eigsolve(lobpcg, al, nev, comm=comm, prec=m, which="SM",
                             tol=1e-8, maxiter=200)

    step.operator, step.row_map, step.preconditioner = al, al.row_map, pc
    return step, ()


def dist_schwarz_entry(dims=(128, 128, 128), n_ranks=None, comm=None,
                       device=None):
    from .parallel.distmatrix import distribute
    from .parallel.driver import dist_schwarz, dist_solve, local_op

    comm = _rank_comm(comm, n_ranks)
    dev = resolve_device(device)
    a = laplace3d(*dims)
    dm = distribute(a, comm.size, fmt="auto")
    al = dm.local(comm.index(), dev)
    pc = dist_schwarz(a, dm.row_map, overlap=1, combine="ZERO")
    m = pc.make(comm, local_op(al, comm), dev)

    def step(b_vec: torch.Tensor):
        return dist_solve(gmres, al, b_vec, comm=comm, prec=m, restart=30,
                          rtol=1e-8, maxiter=1000)

    step.matrix, step.row_map, step.preconditioner = al, dm.row_map, pc
    return step, (_local_rhs(dm.row_map, 3, comm.index(), dev),)


MD_RTOL = 5e-6  # 256³ float32 CG stalls near 1.1e-6 (on an H100): 5x above
MD_CHEB_LMAX = 2.0  # Gershgorin bound of D⁻¹A for the 7-point Laplacian


def dist_md_entry(dims=(256, 256, 256), grid=(2, 2, 1), comm=None,
                  dtype=np.float32, device=None):
    from .galeri.stencils import cross3d_stencil
    from .ops.stencil_poly import chebyshev_stages
    from .parallel.comm import ProcessGrid
    from .parallel.mdarray import (MDMap, md_poly_local, md_solve,
                                   stencil_block_fn)

    dev = resolve_device(device)
    comm = _rank_comm(comm, None)
    pg = (comm if isinstance(comm, ProcessGrid)
          else ProcessGrid(comm, grid, ("x", "y", "z")))
    md_op = MDMap(dims, pg.axis_names, halo=(1, 1, 1))
    md_deep = MDMap(dims, pg.axis_names, halo=(3, 3, 3))
    local_fn = stencil_block_fn(cross3d_stencil(6.0, *([-1.0] * 6)))
    stages = chebyshev_stages(MD_CHEB_LMAX, MD_CHEB_LMAX / 30.0, 3, 1.0 / 6.0)
    prec = md_poly_local(md_deep, pg, local_fn, stages)

    def step(b_blk: torch.Tensor):
        return md_solve(cg, md_op, pg, local_fn, b_blk, prec_local=prec,
                        rtol=MD_RTOL, maxiter=2000)

    step.grid, step.mdmap, step.local_fn = pg, md_op, local_fn
    b = np.random.default_rng(0).standard_normal(md_op.global_shape)
    return step, (md_op.local_block(b, pg, dev, torch_dtype(dtype)),)


def build_entry(solver="CG", prec="CHEBYSHEV", dims=(256, 256, 256),
                params=None, device=None, a=None, dia=None, prec_params=None,
                **prec_kw):
    dev = resolve_device(device)
    if a is None:
        a = laplace3d(*dims, dtype=np.float32)
    if prec_params is None:
        prec_params = ({"chebyshev: degree": 3}
                       if prec.strip().upper() == "CHEBYSHEV" else {})
    mgr, m = build({"Linear Solver Type": solver,
                    "Solver Types": {solver: dict(params or {})},
                    "Preconditioner Type": prec,
                    "Preconditioner Types": {prec: dict(prec_params)}},
                   a, device=dev, **prec_kw)
    if dia is None:
        dia = choose_format(a, device=dev)

    def step(b_vec: torch.Tensor):
        return mgr.solve(LinearProblem(lambda v: spmv(dia, v), b_vec,
                                       right_prec=m))

    step.manager, step.preconditioner = mgr, m
    return step, (_rhs(dia, dev, dia.dtype),)


def _read_matrix_file(path) -> CsrHost:
    """A Matrix Market file (first line ``%%MatrixMarket``, ``.gz`` too)
    through ``read_sparse``, any other through ``read_hb``; the file is
    only read."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        is_mm = f.read(14) == b"%%MatrixMarket"
    return read_sparse(path) if is_mm else read_hb(path)


def mm_block_gmres_entry(nx=32, device=None, path=None, matrix_file=None):
    dev = resolve_device(device)
    if matrix_file is not None:
        if path is not None:
            raise ValueError("give path= (a file to write) or matrix_file= "
                             "(a file to read), not both")
        a = _read_matrix_file(matrix_file)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            mtx = path or pathlib.Path(tmp) / f"recirc2d_{nx}.mtx"
            write_sparse(mtx, recirc2d(nx, nx),
                         comment=f"Galeri recirc2d({nx}, {nx})")
            a = read_sparse(mtx)
    ell = csr_to_ell(a, device=dev)
    ilu = Ilu0(a, {"fact: sweeps": 20}, device=dev).compute()

    def step(b_mv: torch.Tensor):
        return block_gmres(lambda v: spmv(ell, v), b_mv, prec=ilu,
                           num_blocks=60, max_restarts=20, rtol=1e-8,
                           ortho="DGKS")

    step.matrix, step.operator, step.preconditioner = a, ell, ilu
    host = np.zeros((ell.n_rows_pad, 2))
    host[:a.shape[0]] = np.random.default_rng(2).standard_normal(
        (a.shape[0], 2))
    return step, (torch.from_numpy(host).to(dev),)


def _write_complex_mm(path, a) -> None:
    """A host CSR with complex values as Matrix Market coordinate complex
    general (row, column, real part, imaginary part)."""
    rows = a._rows() + 1
    with open(path, "wt") as f:
        f.write("%%MatrixMarket matrix coordinate complex general\n")
        f.write(f"{a.shape[0]} {a.shape[1]} {a.nnz}\n")
        for r, c, v in zip(rows, a.cols + 1, a.vals):
            f.write(f"{r} {c} {v.real:.17g} {v.imag:.17g}\n")


KOMPLEX_PARAMS = {
    "Linear Solver Type": "GMRES",
    "Solver Types": {"GMRES": {"Num Blocks": 30,
                               "Convergence Tolerance": 1e-8,
                               "Maximum Iterations": 1000}},
    "Preconditioner Type": "RILUK"}


def komplex_entry(nx=128, shift=2.0, device=None, path=None):
    dev = resolve_device(device)
    lap = laplace2d(nx, nx)
    n = lap.shape[0]
    idx = np.arange(n)
    az = CsrHost.from_coo(np.concatenate([lap._rows(), idx]),
                          np.concatenate([lap.cols, idx]),
                          np.concatenate([lap.vals.astype(np.complex128),
                                          np.full(n, 1j * shift)]),
                          lap.shape)
    with tempfile.TemporaryDirectory() as tmp:
        mtx = path or pathlib.Path(tmp) / f"shifted_laplace2d_{nx}.mtx"
        _write_complex_mm(mtx, az)
        a = read_sparse(mtx)

    def step(bz):
        return solve_complex(a, bz, KOMPLEX_PARAMS, device=dev)

    step.matrix, step.params = a, KOMPLEX_PARAMS
    rng = np.random.default_rng(5)
    return step, (rng.standard_normal(n) + 1j * rng.standard_normal(n),)


def uncoupled_amg_entry(dims=(16, 16, 16), dtype=np.float32, device=None,
                        amg=None):
    if amg is None:
        amg = SaAmg(laplace3d(*dims, dtype=dtype),
                    {"dtype": dtype, "aggregation: type": "uncoupled"},
                    device=resolve_device(device)).compute()
    return _amg_cg(amg.fine_op, amg)


def _eigen_start_width(mgr, nev, n):
    """Columns of the start block a kind would draw itself (0: a
    vector)."""
    bs = int(mgr.params["Block Size"]) or 0
    return {"lobpcg": bs or nev, "bks": bs or 1, "davidson": bs or nev,
            "gen_davidson": bs or nev, "tracemin": bs or min(nev + 2, n),
            "rtr": bs or nev, "lanczos": 0, "power": 0}[mgr.kind]


def eigen_entry(name, params=None, dims=(16, 16, 16), nev=4,
                dtype=np.float64, device=None, amg=None, mass=None):
    mgr = create_eigensolver(name, params)
    if amg is None:
        op = laplace3d(*dims, dtype=dtype, fmt="stencil")
        dev, dt, st = resolve_device(device), torch_dtype(dtype), None
    else:
        op, dev, dt, st = amg.fine_op, amg.device, amg.dtype, amg.state()
    n, npad = op.n_rows, op.n_rows_pad
    width = _eigen_start_width(mgr, nev, npad)
    host = np.zeros((npad, width) if width else npad)
    host[:n] = np.random.default_rng(7).standard_normal(host[:n].shape)
    m_op = ((lambda v: spmv(mass, v)) if hasattr(mass, "n_rows_pad")
            else mass)

    def step(v0: torch.Tensor, st):
        prec = None if st is None else (lambda v: amg.apply_state(st, v))
        return mgr.solve(EigenProblem(
            op=lambda v: spmv(op, v), n=npad, nev=nev, prec=prec, v0=v0,
            dtype=dt, m=m_op, device=dev))

    step.manager, step.operator = mgr, op
    return step, (torch.from_numpy(host).to(dev, dt), st)
