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

``fem_poisson_entry()``: the FE discretisation layer's path, Q1 Poisson on
the unit cube. ``fem_poisson_problem(dims)`` builds
``structured_hex_mesh(*dims)`` (96³ elements by default: 884,736
hexahedra, 912,673 nodes) and ``poisson_dirichlet`` with the manufactured
source f = 3π² sin(πx) sin(πy) sin(πz), whose solution is
u = sin(πx) sin(πy) sin(πz): K_ii over the 95³ = 857,375 interior nodes,
27 diagonals in lexicographic order, so ``choose_format`` stores it as
DIA. ``SaAmg`` with uncoupled aggregation (float64 by default) takes that
DIA matrix as its fine level; CG at rtol ``FEM_RTOL`` is preconditioned
by its V-cycle. The operator is the DIA matrix (``dia_kernel`` on the
card), or with ``matrix_free=True`` the element stiffness matrices on the
device applied by ``ops.fe.fe_apply_local`` to the interior vector
embedded in all nodes with zeros on the boundary, its interior rows taken:
K_ii·x without the assembled matrix. ``step(b, state)`` as ``entry()``, on
a seed-0 normal right-hand side; ``step.load`` is the manufactured load
(padded) and ``step.problem`` the host problem, whose ``exact`` is u at the
interior nodes; ``step.setup`` holds the set-up seconds (mesh and
assembly, the fine level's format, the rest of the hierarchy, the
matrix-free elements). ``amg=`` and ``problem=`` hand in an earlier call's
hierarchy and problem, so both forms can share them.

``dryrun_multichip(n_ranks)``: the twin of ``__graft_entry__.py``'s
``dryrun_multichip``, a coverage gate at tiny shapes over ``n_ranks``
rank processes (``parallel.driver.launch``). Its rank body,
``dryrun_rank(comm, device)``, runs what the JAX function runs, in its
order: every solver kind and every eigensolver kind
(``parallel/solve_kinds.py``), pipelined CG with Jacobi, CG with
``dist_amg`` and ``dist_amg_blocks``, CG with ``dist_cheb_fused`` and
``dist_amg_structured`` on the z-slab stencil, ``dist_sstep_gmres``,
``dist_spmv_t`` and ``dist_lsqr``, LOBPCG through ``dist_eigsolve``
standard and as a pencil, ``dist_dense_solve``, and for an even rank
count CG and GMRES on a ``make_mesh2`` grid, ``md_map_apply`` of a
9-point stencil and ``md_solve`` on a (2, p/2) ``ProcessGrid``. It raises
if any of them fails and returns what each produced.

``bratu_entry()``: JFNK Newton (``nonlinear.newton_krylov``, type2
forcing, polynomial line search) on 3-D Bratu, F(u) = A u − λh²·mask·e^u
with A the Laplace3D ``StencilOp`` of ``dims``, h² = 1/(nx+1)² and the
mask 0 on the pad rows (``tests/test_nonlinear.py``'s residual in 3-D);
every residual applies the stencil and every Jacobian action is a
``torch.func`` JVP through its derivative rule; the correction solves are
GMRES(30) right-preconditioned by the structured ``SaAmg`` V-cycle (as in
``entry()``; ``amg=`` reuses one), stopping at ‖F‖ ≤ rtol·‖F(0)‖;
``step(u0, state)`` from u0 = 0, with ``step.residual``.

``nonlinear_pde_entry()``: the twin of ``examples/nonlinear_pde.py`` on
the DIA Laplace2D ``nx``²: the steady Newton solve at λ = 1, pseudo-
arclength continuation toward the fold (λ 1 → 6.5) and the adaptive
implicit march of u_t = λe^u − A u/h² to t = 1, with the example's
tolerances; returns the numbers the example prints (counts, maxima, the
drift of the march from the steady state) and the states.

``phalanx_entry()``: −div((1+u²)∇u) = 4 with u = 0 on the boundary of the
unit square, n × n Q1 quadrilaterals, through a ``PhysicsBlock`` and the
evaluator DAG of ``phalanx_fields()`` (``tests/test_phalanx.py``),
solved by JFNK at rtol ``PHALANX_RTOL``; with ``amg=`` (``phalanx_amg(n)``:
uncoupled SA-AMG of ``poisson_dirichlet``'s K_ii, stored as DIA) the
correction solves are preconditioned by its V-cycle on the interior rows
and the identity on the Dirichlet rows. ``step(u0, state)``, with
``step.residual`` and ``step.block``.

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
import time

import numpy as np
import torch

from .device import resolve_device, torch_dtype
from .eigen import EigenProblem, create_eigensolver
from .fem import (FieldManager, Mesh, PhysicsBlock, poisson_dirichlet,
                  structured_hex_mesh, structured_quad_mesh)
from .galeri import (elasticity3d, laplace2d, laplace3d, recirc2d,
                     rigid_body_modes)
from .io import read_hb, read_sparse, write_sparse
from .ops.bdia_spmv import bdia_plane_solver_op
from .ops.fe import fe_apply_local
from .nonlinear import continuation, integrate_adaptive, newton_krylov
from .ops.formats import (CsrHost, choose_format, csr_to_bdia, csr_to_bsr,
                          csr_to_dia, csr_to_ell)
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


FEM_DIMS = (96, 96, 96)  # Q1 hexahedra of fem_poisson_entry
FEM_RTOL = 1e-8
FEM_MAXITER = 1000


def fem_source(x):
    """f = 3π² sin(πx) sin(πy) sin(πz) at points (..., 3): the load whose
    Dirichlet solution on the unit cube is sin(πx) sin(πy) sin(πz)."""
    s = np.sin(np.pi * x)
    return 3.0 * np.pi ** 2 * s[..., 0] * s[..., 1] * s[..., 2]


@dataclasses.dataclass(frozen=True, eq=False)
class FemPoisson:
    """The host side of ``fem_poisson_entry``: the mesh, K_ii, the
    manufactured load on the interior, the interior node ids, every node's
    coordinates, the element stiffness matrices with their node
    connectivity, and the seconds the mesh and assembly took."""

    mesh: Mesh
    kii: CsrHost
    load: np.ndarray
    interior: np.ndarray
    coords: np.ndarray
    elements: np.ndarray
    connect: np.ndarray
    seconds: float

    @property
    def exact(self) -> np.ndarray:
        """The manufactured solution at the interior nodes."""
        return np.prod(np.sin(np.pi * self.coords[self.interior]), axis=1)


def fem_poisson_problem(dims=FEM_DIMS) -> FemPoisson:
    t0 = time.perf_counter()
    mesh = structured_hex_mesh(*dims)
    kii, load, interior, xy, ke, conn = poisson_dirichlet(
        mesh, fem_source, elements=True)
    return FemPoisson(mesh, kii, load, interior, xy, ke, conn,
                      time.perf_counter() - t0)


def _synced_seconds(t0, dev) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def fem_poisson_entry(dims=FEM_DIMS, dtype=np.float64, device=None,
                      amg=None, matrix_free=False, problem=None):
    prob = problem or fem_poisson_problem(dims)
    setup = {"mesh_assembly": prob.seconds}
    if amg is None:
        dev = resolve_device(device)
        t0 = time.perf_counter()
        fine = choose_format(prob.kii, dtype=dtype, device=dev)
        setup["format"] = _synced_seconds(t0, dev)
        t0 = time.perf_counter()
        amg = SaAmg(prob.kii, {"dtype": dtype,
                               "aggregation: type": "uncoupled",
                               "fine: matrix-free operator": fine},
                    device=dev).compute()
        setup["amg"] = _synced_seconds(t0, dev)
    elif amg.fine_op.shape != prob.kii.shape:
        raise ValueError(f"the hierarchy's fine level is "
                         f"{amg.fine_op.shape}, K_ii {prob.kii.shape}")
    fine, dev, dt = amg.fine_op, amg.device, amg.dtype
    n = fine.n_rows
    if matrix_free:
        t0 = time.perf_counter()
        ke = torch.from_numpy(prob.elements).to(dev, dt)
        conn = torch.from_numpy(prob.connect).to(dev)
        inner = torch.from_numpy(prob.interior).to(dev)
        n_nodes = len(prob.coords)
        setup["elements"] = _synced_seconds(t0, dev)

        def apply(v):
            # K_ii·v: v on the interior nodes, zero on the boundary
            full = v.new_zeros((n_nodes,) + v.shape[1:])
            full[inner] = v[:n]
            y = torch.zeros_like(v)
            y[:n] = fe_apply_local(conn, ke, full)[inner]
            return y
    else:
        def apply(v):
            return spmv(fine, v)

    def step(b_vec: torch.Tensor, st: dict):
        return cg(apply, b_vec, prec=lambda v: amg.apply_state(st, v),
                  rtol=FEM_RTOL, maxiter=FEM_MAXITER)

    load = np.zeros(fine.n_rows_pad)
    load[:n] = prob.load
    step.problem, step.preconditioner, step.operator = prob, amg, fine
    step.apply, step.setup = apply, setup
    step.load = torch.from_numpy(load).to(dev, dt)
    return step, (_rhs(fine, dev, dt), amg.state())


def _dryrun_check(label, x, want_shape) -> None:
    if tuple(x.shape) != tuple(want_shape):
        raise AssertionError(f"{label}: shape {tuple(x.shape)}, expected "
                             f"{tuple(want_shape)}")


def _nine_point(p):
    return (8.0 * p[1:-1, 1:-1] - p[:-2, 1:-1] - p[2:, 1:-1]
            - p[1:-1, :-2] - p[1:-1, 2:] - p[:-2, :-2] - p[2:, 2:]
            - p[:-2, 2:] - p[2:, :-2])


def _five_point(p):
    return (4.0 * p[1:-1, 1:-1] - p[:-2, 1:-1] - p[2:, 1:-1]
            - p[1:-1, :-2] - p[1:-1, 2:])


def dryrun_rank(comm, device=None) -> dict:
    from .eigen import lobpcg
    from .parallel import distmatrix as D
    from .parallel import driver as drv
    from .parallel.comm import ProcessGrid
    from .parallel.dist_setup import split_rows
    from .parallel.mdarray import MDMap, md_map_apply, md_solve
    from .parallel.solve_kinds import (run_all_eigen_kinds,
                                       run_all_solver_kinds)
    from .solvers import dist_dense_solve

    dev = resolve_device(device)
    p, me = comm.size, comm.index()
    out = {"solver_kinds": run_all_solver_kinds(comm, dev),
           "eigen_kinds": run_all_eigen_kinds(comm, dev)}
    steps = out["steps"] = {}

    def solve(label, res, like):
        _dryrun_check(label, res.x, like.shape)
        steps[label] = res

    a = laplace2d(16, 2 * p, dtype=np.float32)
    dm = D.distribute(a, p)
    al = dm.local(me, dev)
    prec = drv.dist_jacobi(a, dm.row_map, dtype=np.float32)
    bg = _local_rhs(dm.row_map, 0, me, dev, torch.float32)
    solve("cg_pipeline", drv.dist_solve(cg_pipeline, al, bg, comm=comm,
                                        prec=prec, rtol=1e-4, maxiter=5), bg)
    amg = drv.dist_amg(a, dm.row_map, coarse_max=16, dtype=np.float32)
    solve("amg", drv.dist_solve(cg, al, bg, comm=comm, prec=amg, rtol=1e-4,
                                maxiter=5), bg)
    # the distributed set-up: no global matrix is assembled
    amg_b = drv.dist_amg_blocks(split_rows(a, dm.row_map), dm.row_map,
                                coarse_max=16, dtype=np.float32)
    solve("amg_blocks", drv.dist_solve(cg, al, bg, comm=comm, prec=amg_b,
                                       rtol=1e-4, maxiter=5), bg)

    # the z-slab stencil: CA fused Chebyshev, then structured AMG
    ops = laplace3d(16, 8, 8 * p, dtype=np.float32, fmt="stencil")
    sl = D.distribute_stencil(ops, p).local(me, dev)
    cheb = drv.dist_cheb_fused(ops, p, degree=3, lmax=1.9, lmin=0.06,
                               device=dev)
    bs = _local_rhs(sl.row_map, 3, me, dev, torch.float32)
    solve("cheb_fused", drv.dist_solve(cg, sl, bs, comm=comm, prec=cheb,
                                       rtol=1e-4, maxiter=5), bs)
    samg = drv.dist_amg_structured(ops, p, dtype=np.float32, device=dev)
    solve("amg_structured", drv.dist_solve(cg, sl, bs, comm=comm, prec=samg,
                                           rtol=1e-4, maxiter=5), bs)
    solve("sstep", drv.dist_sstep_gmres(ops, bs, comm=comm, s=2, t_blocks=2,
                                        max_restarts=1, rtol=1e-4), bs)

    # the transpose apply, LSQR, and LOBPCG standard and as a pencil
    steps["spmv_t"] = drv.dist_spmv_t(al, bg, comm)
    _dryrun_check("spmv_t", steps["spmv_t"], bg.shape)
    solve("lsqr", drv.dist_lsqr(al, bg, comm=comm, rtol=1e-4, maxiter=5), bg)
    steps["lobpcg"] = drv.dist_eigsolve(lobpcg, al, 2, comm=comm,
                                        which="LM", tol=1e-3, maxiter=5,
                                        dtype=np.float32)
    steps["lobpcg+M"] = drv.dist_eigsolve(lobpcg, al, 2, comm=comm,
                                          mass_matrix=al, which="SM",
                                          tol=1e-3, maxiter=5,
                                          dtype=np.float32)

    # the column-block dense LU
    nd = 8 * p
    ad = (np.random.default_rng(2).standard_normal((nd, nd))
          + nd * np.eye(nd)).astype(np.float32)
    steps["dense"] = dist_dense_solve(comm, ad, np.ones(nd, np.float32),
                                      nb=8, device=dev)
    _dryrun_check("dense", steps["dense"], (nd,))

    if p % 2 == 0:
        # the two-level (dcn, rows) grid: rows over both axes
        mesh2 = drv.make_mesh2(comm, 2, p // 2)
        solve("grid_cg", drv.dist_solve(cg, al, bg, comm=mesh2, prec=prec,
                                        rtol=1e-4, maxiter=5), bg)
        solve("grid_gmres", drv.dist_solve(gmres, al, bg, comm=mesh2,
                                           rtol=1e-4, maxiter=5, restart=4),
              bg)
        # Domi's MDMap on a (2, p/2) process grid: the 9-point stencil's
        # halo exchange (corners included), then CG through md_solve
        grid = ProcessGrid(comm, (2, p // 2), ("mx", "my"))
        shape = (8, 4 * p)
        md = MDMap(shape, ("mx", "my"), halo=(1, 1), periodic=(True, True))
        u = md.local_block(np.random.default_rng(1).standard_normal(
            shape).astype(np.float32), grid, dev)
        steps["md_apply"] = md_map_apply(md, grid, _nine_point)(u)
        _dryrun_check("md_apply", steps["md_apply"], u.shape)
        md_d = MDMap(shape, ("mx", "my"), halo=(1, 1))
        bmd = md_d.local_block(np.random.default_rng(4).standard_normal(
            shape).astype(np.float32), grid, dev)
        solve("md_cg", md_solve(cg, md_d, grid, _five_point, bmd, rtol=1e-4,
                                maxiter=5), bmd)
    return out


def dryrun_multichip(n_ranks: int, device=None, **launch_kw) -> list:
    """``dryrun_rank`` in ``n_ranks`` rank processes; other keywords go to
    ``parallel.driver.launch``. Returns each rank's result in rank
    order."""
    from .parallel.driver import launch

    return launch(dryrun_rank, n_ranks, device=device, **launch_kw)


# -- the application layer: NOX/LOCA/Tempus and Phalanx ----------------------

BRATU_LAMBDA = 4.0


def bratu_entry(dims=(16, 16, 16), lam=BRATU_LAMBDA, dtype=np.float32,
                device=None, amg=None, rtol=1e-5):
    op, m = _hierarchy(dims, dtype, device, amg)
    n, npad = op.n_rows, op.n_rows_pad
    h2 = 1.0 / (op.dims[0] + 1) ** 2
    mask = torch.zeros(npad, dtype=m.dtype, device=m.device)
    mask[:n] = 1.0
    scale = lam * h2 * mask

    def residual(u: torch.Tensor) -> torch.Tensor:
        return spmv(op, u) - scale * torch.exp(u)

    def step(u0: torch.Tensor, st: dict):
        def prec(v):
            return m.apply_state(st, v)

        return newton_krylov(residual, u0, prec_factory=lambda x: prec,
                             rtol=rtol, forcing="type2",
                             linesearch="polynomial")

    step.residual, step.operator, step.preconditioner = residual, op, m
    step.h2, step.lam = h2, lam
    return step, (torch.zeros(npad, dtype=m.dtype, device=m.device),
                  m.state())


NLPDE_ATOL = 1e-5  # the example's continuation and march Newton atol
NLPDE_STEADY_ATOL = 3e-6  # the example's steady Newton atol


def nonlinear_pde_entry(nx=24, dtype=np.float32, device=None) -> dict:
    dev, dt = resolve_device(device), torch_dtype(dtype)
    a = csr_to_dia(laplace2d(nx, nx), dtype=dtype, device=dev)
    n, npad = a.n_rows, a.n_rows_pad
    h2 = 1.0 / (nx + 1) ** 2
    mask = torch.zeros(npad, dtype=dt, device=dev)
    mask[:n] = 1.0

    def residual(u, lam):
        return mask * (spmv(a, u) - h2 * lam * torch.exp(u) * mask)

    u0 = torch.zeros(npad, dtype=dt, device=dev)
    res = newton_krylov(lambda u: residual(u, 1.0), u0, rtol=0.0,
                        atol=NLPDE_STEADY_ATOL)
    path = continuation(residual, res.x, p0=1.0, p_final=6.5, dp0=0.5,
                        arclength=True, max_steps=40, newton_rtol=0.0,
                        newton_atol=NLPDE_ATOL)

    def rhs(t, u):
        return mask * (1.0 * torch.exp(u) * mask - spmv(a, u) / h2)

    march = integrate_adaptive(rhs, u0, 0.0, 1.0, 0.02, order=2, rtol=1e-5,
                               newton_atol=NLPDE_ATOL)
    return {
        "newton_converged": res.converged, "newton_iters": res.iters,
        "newton_inner": res.inner_iters, "newton_fnorm": res.fnorm,
        "newton_max_u": float(torch.max(res.x)),
        "cont_points": len(path.params), "cont_failed": path.steps_failed,
        "cont_newton": path.newton_iters,
        "cont_max_lambda": float(path.params.max()),
        "cont_max_u": float(torch.max(path.xs[-1])),
        "march_steps": march.steps, "march_rejected": march.rejected,
        "march_newton": march.newton_iters,
        "march_max_u": float(torch.max(march.u)),
        "drift": float(torch.linalg.norm(march.u - res.x)),
        "u_steady": res.x, "u_march": march.u, "lambdas": path.params,
    }


PHALANX_SOURCE = 4.0  # -div((1 + u²) grad u) = 4 on the unit square


def phalanx_fields() -> FieldManager:
    """The nonlinear Poisson DAG: κ = 1 + u², flux = κ ∇u, source 4."""
    fm = FieldManager()

    @fm.add("kappa", provides="kappa_qp", requires="u_qp")
    def _kappa(u):
        return 1.0 + u * u

    @fm.add("flux", provides="flux_qp", requires=("kappa_qp", "grad_u_qp"))
    def _flux(k, g):
        return k[..., None] * g

    @fm.add("source", provides="source_qp", requires="x_qp")
    def _source(x):
        return PHALANX_SOURCE * torch.ones(x.shape[:-1], dtype=x.dtype,
                                           device=x.device)

    return fm


def phalanx_amg(n=8, dtype=np.float64, device=None) -> SaAmg:
    """Uncoupled SA-AMG of ``poisson_dirichlet``'s K_ii on the n × n Q1
    quadrilaterals (stored through ``choose_format``: DIA), the fixed
    preconditioner ``phalanx_entry`` takes as ``amg=``."""
    dev = resolve_device(device)
    kii = poisson_dirichlet(structured_quad_mesh(n, n),
                            lambda x: np.full(x.shape[:-1],
                                              PHALANX_SOURCE))[0]
    fine = choose_format(kii, dtype=dtype, device=dev)
    return SaAmg(kii, {"dtype": dtype, "aggregation: type": "uncoupled",
                       "fine: matrix-free operator": fine},
                 device=dev).compute()


PHALANX_RTOL = 1e-10  # the JAX test's Newton rtol (tests/test_phalanx.py)


def phalanx_entry(n=8, dtype=np.float64, device=None, amg=None):
    mesh = structured_quad_mesh(n, n)
    dev = resolve_device(device) if amg is None else amg.device
    pb = PhysicsBlock(mesh, dtype=dtype, device=dev)
    bnd = pb.boundary_dofs()
    residual = pb.residual_function(phalanx_fields(), dirichlet=bnd)
    interior = np.setdiff1d(np.arange(pb.n_dof), bnd)
    if amg is not None and amg.fine_op.n_rows != len(interior):
        raise ValueError(f"the hierarchy's fine level has "
                         f"{amg.fine_op.n_rows} rows, the mesh "
                         f"{len(interior)} interior dofs")
    inner = torch.from_numpy(interior).to(dev)
    ni = len(interior)

    def step(u0: torch.Tensor, st):
        prec_factory = None
        if st is not None:
            npad = amg.fine_op.n_rows_pad

            def prec(v):
                # the V-cycle on the interior rows, the identity on the
                # Dirichlet rows
                z = torch.zeros(npad, dtype=v.dtype, device=v.device)
                z[:ni] = v[inner]
                return v.index_put((inner,), amg.apply_state(st, z)[:ni])

            def prec_factory(x):
                return prec
        return newton_krylov(residual, u0, prec_factory=prec_factory,
                             rtol=PHALANX_RTOL)

    step.residual, step.block, step.boundary = residual, pb, bnd
    step.preconditioner = amg
    return step, (torch.zeros(pb.n_dof, dtype=pb.w.dtype, device=dev),
                  None if amg is None else amg.state())
