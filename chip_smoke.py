"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``trilinos_tpu_torch/csrc/``
and the native host SpGEMM, holds each kernel against its plain PyTorch
version on the card at every shape the paths give it, and drives ten
paths, each once through the kernels and once through the plain versions,
before the factory's paths below. Seven run on the 256³ Laplace3D
stencil:

* structured-AMG-preconditioned CG (``entry``) and AMG-preconditioned
  block GMRES, nrhs = 16, CGS2 + CholQR2 (``block_entry``), on one
  hierarchy with the damped-Jacobi smoother;
* AMG-PCG with the Chebyshev smoother (``cheb_entry``) on a second
  hierarchy;
* s-step GMRES with the matrix-powers basis (``sstep_entry``);
* fused-iteration CG (``fused_cg_entry``);
* GMRES(30) with CGS2 at a fixed 120 iterations (``gmres_entry``, the JAX
  bench's ``bench_gmres`` at this grid), with an f32 and then a bf16
  basis, and AMG-preconditioned GMRES(30) on the CG path's hierarchy.

Two run on Galeri 3-D Q1 elasticity through the BDIA kernel:

* CG preconditioned by the block-structured null-space AMG
  (``elasticity_entry``) on 32³ nodes (98,304 dofs), every level a
  BdiaMatrix (b = 3, then b = 6);
* CG in plane layout (``bdia_cg_entry``) on 64×64×48 nodes, 400
  iterations.

BASELINE config 2 (``bsr_gmres_entry``: Laplace3D 64³ stored as BSR with
b = 4, Relaxation, pseudo-block GMRES(30) on 4 right-hand sides, f64) runs
no hand-written kernel; it is gated on every column's true residual, and
``fgmres``, ``gmres_single_reduce`` and ``gmres_pipeline`` run its column 0.

Then the solver factory: every single-RHS Belos kind through
``create_solver(name).solve(LinearProblem(...))`` (``factory_entry``) on
the 256³ stencil and the CG path's hierarchy (CG with its condition
estimate and residual history, Pipelined CG, stochastic CG, RCG, MINRES,
BiCGStab, TFQMR, Fixed Point, GCRODR twice, the second solve from the
first's recycle space, Hybrid Block GMRES, and LSQR unpreconditioned at a
fixed 200 iterations), Block CG with 16 right-hand sides and Block GCRODR
with 4; BASELINE config 4 on one card (``pipelined_cg_entry``: Laplace3D
128³ as DIA, f64, pipelined CG, rtol 1e-8); and the Stratimikos path
(``build_entry``) on the 256³ Laplace3D stored as DIA from a host CSR:
CG + CHEBYSHEV, and GMRES(30) + GMRESPOLY at a fixed 60 iterations, whose
true residual must fall below plain GMRES(30)'s. LSQR, Block CG, config
4 and the Chebyshev solve run again through the plain versions.

Then the stored-matrix path (BASELINE config 3's twin on a Matrix Market
file it is given and must leave untouched, uncoupled SA-AMG, every
preconditioner name through ``build()``, two-level Schwarz among them, each
beside the JAX package's CPU count) and the direct solvers: the native
sparse LU and Cholesky on the host at 16,384 and 65,536 rows, the Amesos2
names through ``build()`` (a dense inverse on the card), two-level Schwarz
CG on laplace2d 256² beside one-level, a complex solve through its real
form (``komplex_entry``), ``dense_solve`` and Teko's blocked GMRES.

Then the eigensolvers, f64, through ``eigen_entry`` and the factory, each
gated on Laplace3D's closed-form spectrum and held to its plain run: on
one 256³ Jacobi hierarchy AMG-LOBPCG and AMG-Block Davidson (the four
smallest pairs), block Krylov-Schur at a fixed 20 restarts (its basis
stays on the card; the largest copy to the host is recorded) and
converged at 14³, TraceMin, RTR, LANCZOS and POWER at 64³, Generalized
Davidson on recirc2d 128² at a fixed 40 iterations, LOBPCG on the Q1 mass
pencil at 256³ and AMG-Block Davidson on it at 64³, and ``eigs_near`` at
64³, each beside the JAX package's CPU count
(``scripts/eigen_cpu_counts.py``).

Then the FE discretisation layer: Q1 Poisson on 80³ hexahedra
(``fem_poisson_entry``: mesh, assembly and Dirichlet condensation on the
host, K_ii as 27-diagonal DIA through ``dia_kernel``, uncoupled SA-AMG PCG
at rtol 1e-8 on the assembled operator and on the matrix-free one of
``fe_apply_local``), the manufactured solution's nodal error, and the
solution through a VTK file and back.

Then the distributed layer, 4 rank processes on the one card over gloo
and one rank over nccl: config 4 row-partitioned at 128³, structured
AMG-PCG on 256³ z-slabs, fused Chebyshev and SA-AMG PCG at 64³, s-step
GMRES at 256³ (one depth-4 exchange and one ``poly_kernel`` launch a
block step on each rank's extended slab, held to the single card's run),
AMG-LOBPCG at 256³ and GMRES(30) with restricted Schwarz at 128³ and 64³
(``scripts/dist_cpu_counts.py`` gives the JAX package's 4-shard counts),
then config 4 again on a (2, 2) rank grid (``make_mesh2``: the flat
layout's iterations and x, bit for bit), Laplace3D on a (2, 2, 1) rank
grid through Domi's MDMap (``dist_md_entry``: CG with the CA Chebyshev
sweep, the operator and every stage on the padded block through
``stencil_kernel``) at 256³ f32 and 64³ f64 (the JAX package's count), and
the column-block dense LU (``dist_dense_solve``, n = 8192, f64, 4
right-hand sides), and the dryrun's rank body (``entry.dryrun_rank``:
every solver and eigensolver kind of the factories over the ranks, then
its tiny distributed solves); each rank's kernels held bitwise against
their plain versions on its data.

Then the application layer (``application_phase``): the kernel wrappers'
derivative rules at the kernels' shapes (the 256³ f32 and 64³ f64
stencil, the DIA level 1 at k = 1 and 4, the elasticity BDIA level 0:
JVP tangents against the wrapper on the tangent and the plain version's
JVP, VJP cotangents against the transpose apply, the forward-over-reverse
Hessian-vector product of ½xᵀAx against A v, two launches a JVP); JFNK
Newton on 3-D Bratu at 256³ f32 (``bratu_entry`` on the CG path's
hierarchy, ``stencil_kernel`` in every residual and Jacobian action,
``dia_kernel`` in the V-cycle) through the kernels and through the plain
versions; the nonlinear PDE example (``nonlinear_pde_entry``, 24², f32
and f64) against the CPU's counts; Phalanx's JFNK nonlinear Poisson on
512² Q1 quadrilaterals, f64, AMG-preconditioned (``phalanx_entry``);
Piro's steady solve with adjoint sensitivities against a central
difference and a transient at 32³ f64; ROL's trust-region Newton-CG on a
32³ quadratic and L-BFGS on Rosenbrock at n = 2²⁰.

Every hierarchy set-up must be served by the native SpGEMM, and every
factorization by the native library. Each path
is driven with the launch counts set to 0 just before it and read just
after. It times each warm solve, times each kernel (device time of
CUDA-graph replays, and the host path of calls from Python) beside its
bound, its plain version and one PyTorch library call where there is one
(both by graph replay), profiles one solve of each path (device time by
kernel), prints its total time, and ends with one JSON line naming the
device. Any failure exits non-zero; without a CUDA device it exits
non-zero before doing anything.
"""
import collections
import contextlib
import dataclasses
import json
import multiprocessing
import pathlib
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from unittest import mock

import numpy as np
import torch

DIMS = (256, 256, 256)  # Laplace3D, 16.7 M unknowns
GRID = "x".join(map(str, DIMS))
NRHS = 16  # the block path's right-hand sides (BASELINE config 5)
RTOL = 1e-5  # both solves' tolerance; the true residual's gate
HBM_BYTES_PER_MS = 3.35e12 / 1e3  # H100 SXM device memory, 3.35 TB/s
F32_FLOPS_PER_MS = 67e12 / 1e3  # H100 SXM float32 outside the tensor cores
TOL = {torch.float32: 1e-6, torch.float64: 1e-13}
# chol_inv_small: kernel and plain version sum in different orders (the
# plain version's matvecs go through cuBLAS) and take rsqrt differently, so
# they agree to the type's rounding amplified by the factor's conditioning,
# not to the bit. Gates, by dtype: kernel vs plain, and the kernel's own
# residuals ‖L·Lᵀ − g‖/‖g‖ (backward error of a Cholesky factor, a few
# eps) and max|L⁻¹·L − I| (grows with cond(L), ≤ 10 on these panels). The
# f64 gates sit about 1000× above f64 rounding and below f32's, so a kernel
# that computed in f32 for f64 input fails them (the f32-rounded control
# in section 5 shows it does).
CHOL_TOL = {torch.float32: {"vs_plain": 1e-4, "llt": 1e-5, "inv": 1e-4},
            torch.float64: {"vs_plain": 1e-12, "llt": 1e-13, "inv": 1e-12}}
# the kernel and plain block solves stop at rtol 1e-5 along slightly
# different rounding, so their x agree to about the tolerance, not better
BLOCK_X_TOL = 1e-4
# cg_fused sums its dots per block in double, the plain version with
# torch.sum in f32; the difference in α, β compounds over the iterations.
# On an H100 the chained vectors and scal read at most 1.24e-6 and the
# 100-iteration x 1.15e-6: the gates sit about 10× above.
CG_FUSED_TOL = 1e-5  # five chained iterations: vectors and scal
FUSED_CG_X_TOL = 1e-5  # the first 100 iterations of the fused-CG path
# s-step GMRES: chol_inv_small agrees with its plain version to a
# tolerance, so the CholQR2 bases of the two runs differ by rounding
SSTEP_TOL = 1e-4  # per-cycle residual norms and x
FUSED_CG_ITERS = 100
# elasticity AMG-PCG nodes: 98,304 dofs. The block hierarchy's host set-up
# is the script's largest (94–119 s at 48³, 53–60 s at 40³ on the card's
# host), and a slow host took the whole script to 1344.3 s with the
# application phase, so the grid is 32³ to keep it inside its time limit
EL_DIMS = (32, 32, 32)
PLANE_DIMS = (64, 64, 48)  # plane-layout CG nodes: 589,824 dofs
PLANE_ITERS = 400
BDIA2D_DIMS = (1024, 512)  # the JAX bench's bare BDIA apply, b = 2
BDIA_X_TOL = 1e-4  # kernel and plain elasticity AMG-PCG stop at rtol 1e-5
PLANE_X_TOL = 1e-5  # the first PLANE_CHECK_ITERS plane-CG iterations
PLANE_CHECK_ITERS = 20
GMRES_ITERS = 120  # fixed-work GMRES(30) at rtol 0: four cycles
GMRES_BF16_X_TOL = 1e-4  # kernel and plain runs with a bf16 basis
CONFIG2_DIMS = (64, 64, 64)  # BASELINE config 2 at its stated size
CONFIG2_RTOL = 1e-7  # its true-residual gate, every column
LSQR_ITERS = 200  # LSQR through the factory at rtol 0: a fixed count
# its true residual after those steps: about twice the 1.398e-2 that the
# kernel and plain runs both read at 256³ (H100, f32); the run is fixed-work
LSQR_TRUE_MAX = 3e-2
POLY_ITERS = 60  # GMRES(30) + GmresPoly through build(): two cycles, rtol 0
CONFIG4_DIMS = (128, 128, 128)  # BASELINE config 4 on one card
CONFIG4_RTOL = 1.1e-8  # the JAX test's gate: ‖b − A x‖ ≤ 1.1e-8 ‖b‖
CONFIG4_CPU_ITERS = 447  # unpreconditioned CG on this problem, CPU, f64
# the DIA kernel at k = 1 sums each row in the plain version's order, so the
# kernel and plain config-4 solves may part only by rounding
CONFIG4_X_TOL = 1e-8
F64_FLOPS_PER_MS = 34e12 / 1e3  # H100 SXM float64 outside the tensor cores
# the stored-matrix path. BASELINE config 3's twin: Galeri recirc2d 128²
# (16,384 rows, default diffusion) through a Matrix Market file, ELL, Ilu0
# with 20 sweeps, DGKS block GMRES (nrhs 2, 60 blocks, 20 restarts, f64)
CONFIG3_NX = 128
CONFIG3_CPU_STEPS = 649  # the JAX package on the CPU, f64
CONFIG3_STEPS_TOL = 0.05  # kernel-run block steps within 5% of that count
CONFIG3_TRUE_MAX = 1e-6  # every column's true residual (the JAX test's)
UAMG_DIMS = (128, 128, 128)  # uncoupled SA-AMG PCG on a stored Laplace3D
UAMG_X_TOL = 1e-4  # kernel and plain f32 solves stop at rtol 1e-5
NS_MAXITER = 400  # null-space uncoupled SA-AMG PCG on the elasticity matrix
MAXWELL_DIMS = (128, 128)  # HIPTMAIR's curl-curl problem, 33,024 edges


def box_ids(nx, k):
    """Subdomain ids of k × k square boxes on an nx × nx row-major grid (x
    fastest), by index arithmetic: the port has no partitioner yet."""
    i = np.arange(nx * nx)
    w = nx // k
    return (i // nx // w) * k + (i % nx) // w


# the tenth slice's names and the eleventh's two-level Schwarz, through
# build() with GMRES(30)
# at rtol 1e-8, maxiter 1000, f64, on the config-3 matrix (HIPTMAIR on
# maxwell2d with conductivity 10^U(-3, 0), seed 9): (label, name,
# parameters, GMRES iterations of the JAX package on the CPU in f64 from
# scripts/stored_path_cpu_counts.py). The convection-dominated matrix needs
# more than the defaults: fixed-sweep ILU 20-80 sweeps, block relaxation on
# grid lines with 20 sweeps, Gauss-Seidel 20 symmetric sweeps; HIPTMAIR's
# edge smoother needs a damping below 2 / λmax(D⁻¹A) ≈ 0.67.
BUILD_CASES = [
    ("RILUK level 0", "RILUK", {"fact: sweeps": 80}, 707),
    ("RILUK level 1", "RILUK", {"fact: iluk level-of-fill": 1,
                                "fact: sweeps": 20}, 729),
    ("ILUT", "ILUT", {"fact: sweeps": 20}, 391),
    ("BLOCK RELAXATION Dense", "BLOCK RELAXATION",
     {"partitioner: block size": 128, "relaxation: sweeps": 20}, 266),
    ("TRIDI", "TRIDI", {"relaxation: container": "TriDi",
                        "partitioner: block size": 128,
                        "relaxation: sweeps": 20}, 266),
    ("BANDED RELAXATION", "BANDED RELAXATION",
     {"relaxation: container": "Banded", "partitioner: block size": 128,
      "banded: bandwidth": 2, "relaxation: sweeps": 20}, 266),
    ("BLOCK RELAXATION SparseILU0", "BLOCK RELAXATION",
     {"relaxation: container": "SparseILU0", "partitioner: block size": 1024,
      "relaxation: sweeps": 10}, 136),
    ("DATABASE SCHWARZ", "DATABASE SCHWARZ",
     {"relaxation: container": "Database", "partitioner: block size": 128,
      "relaxation: sweeps": 20}, 266),
    ("MT GAUSS-SEIDEL", "MT GAUSS-SEIDEL",
     {"relaxation: sweeps": 20, "relaxation: symmetric": True}, 200),
    ("SCHWARZ restricted", "SCHWARZ", {"schwarz: num subdomains": 16}, 874),
    ("ADDITIVE SCHWARZ add", "ADDITIVE SCHWARZ",
     {"schwarz: num subdomains": 16, "schwarz: combine mode": "add"}, 872),
    ("HIPTMAIR", "HIPTMAIR", {"hiptmair: aux preconditioner": "SA-AMG",
                              "hiptmair: damping factor": 0.4}, 60),
    # 16 subdomains as 4 × 4 boxes of 32²: contiguous row chunks would be
    # slabs, on which the reference's RGDSW basis is rank-deficient
    ("TWO-LEVEL SCHWARZ rgdsw hybrid RAS", "TWO-LEVEL SCHWARZ",
     {"schwarz: num subdomains": 16,
      "schwarz: subdomain ids": box_ids(CONFIG3_NX, 4)}, 115),
    ("FROSCH constant hybrid RAS", "FROSCH",
     {"schwarz: num subdomains": 16,
      "schwarz: subdomain ids": box_ids(CONFIG3_NX, 4),
      "coarse space: type": "constant"}, 119),
    ("GDSW rgdsw additive RAS", "GDSW",
     {"schwarz: num subdomains": 16,
      "schwarz: subdomain ids": box_ids(CONFIG3_NX, 4),
      "coarse space: coupling": "additive"}, 160),
]
BUILD_RTOL = 1e-8
# the eleventh slice: the direct solvers and what they free
DIRECT_HOST_RHS = 4  # seeded right-hand sides of the host direct solves
DIRECT_HOST_TRUE_MAX = 1e-10  # each column's true relative residual
CHOL_NX = 256  # SparseCholesky on laplace2d 256² (65,536 rows)
# the Amesos2 names through build() at 64² (4,096 rows: the dense inverse
# is n² by the reference's design, 134 MB in f64): (name, solver, matrix,
# iterations of the JAX package on the CPU in f64 from
# scripts/stored_path_cpu_counts.py), rtol 1e-8, f64
DIRECT_NX = 64
DIRECT_CASES = [("DIRECT", "GMRES", "recirc2d", 1),
                ("AMESOS2", "GMRES", "recirc2d", 1),
                ("KLU2", "GMRES", "recirc2d", 1),
                ("TACHO", "CG", "laplace2d", 1),
                ("CHOLMOD", "CG", "laplace2d", 1)]
DIRECT_TRUE_MAX = 1e-7
# two-level Schwarz CG on laplace2d CHOL_NX² with the "add" combine on
# TL_BOXES × TL_BOXES boxes, beside one-level Schwarz on the same partition
# (CPU f64 counts: two-level, one-level)
TL_BOXES = 8
TL_CPU_ITERS = (45, 94)
TL_RTOL = 1e-8
# Komplex: the complex shifted Laplacian laplace2d 128² + 2i·I through a
# complex Matrix Market file, GMRES(30) + RILUK on the real form
KOMPLEX_NX = 128
KOMPLEX_SHIFT = 2.0
KOMPLEX_CPU_ITERS = 15
KOMPLEX_TRUE_MAX = 1e-7
DENSE_N = 4096  # dense_solve (Pliris on one card), f64
DENSE_TRUE_MAX = 1e-10
TEKO_CPU_ITERS = 11  # blocked GMRES(40) + block Gauss-Seidel, rtol 1e-10
# the Anasazi eigensolvers through eigen_entry / the factory, f64: nev
# pairs to the factory's default tolerance (an absolute residual norm)
EIG_NEV = 4
EIG_TOL = 1e-8
EIG_CLOSED_RTOL = 1e-8  # each eigenvalue against the closed form
EIG_PLAIN_RTOL = 1e-10  # kernel and plain runs' eigenvalues
EIG_SUBSPACE_TOL = 1e-6  # sin of the largest angle between their blocks
# Block Krylov-Schur LM at 256³ (block size 2, 20 blocks of columns) at a
# fixed restart budget: rtol 0, 20 restarts, 20 + 20·12 = 260 steps
BKS_RESTARTS = 20
BKS_STEPS = 260
# the leading Ritz value must lie in [λmax − BKS_LEAD_WINDOW, λmax]: 260
# steps resolve the top of a fine grid's spectrum only to about 1e-3 (the
# port's CPU runs: 3.4e-4 below λmax at 64³, 1.23e-3 at 128³)
BKS_LEAD_WINDOW = 1e-2
# the largest Laplace3D grid whose BKS LM (the same parameters at rtol
# 1e-8) the JAX package converges within its 20 restarts on the CPU, and
# its total steps there (scripts/eigen_cpu_counts.py)
BKS_CONV_DIMS = (14, 14, 14)
BKS_CONV_CPU_STEPS = 224
# TraceMin, RTR, LANCZOS and POWER through eigen_entry, Block Davidson on
# the Q1 mass pencil and eigs_near on this grid; Generalized Davidson on
# recirc2d CONFIG3_NX² (LM, a fixed EIG_GD_ITERS iterations: it does not
# converge there within its default 200 in the JAX package either)
EIG_SMALL_DIMS = (64, 64, 64)
EIG_SMALL_CASES = [("TraceMin", {}), ("RTR", {}),
                   ("LANCZOS", {"Which": "LA", "Num Blocks": 200}),
                   ("POWER", {"Maximum Iterations": 200})]
EIG_GD_ITERS = 40
EIG_LANCZOS_RTOL = 1e-6  # LANCZOS's leading Ritz value against λmax
# the JAX package's CPU f64 counts on the same grids and starts
# (scripts/eigen_cpu_counts.py): iterations, Ritz values where fixed-count
EIG_CPU = {"TraceMin": 65, "RTR": 24, "LANCZOS": 200, "POWER": 200,
           "Generalized Davidson": EIG_GD_ITERS, "Block Davidson mass": 20,
           "eigs_near": 28}
EIG_CPU_VALUES = {"LANCZOS": 11.992993347212352,  # the leading Ritz value
                  "POWER": 11.943743546501134,
                  "Generalized Davidson": 228.61304284406185}  # max |θ|


# the distributed layer (section 7x): rank processes on the one card over
# the gloo transport, which stages device buffers through host memory
DIST_RANKS = 4
DIST_C4_DIMS = (128, 128, 128)  # BASELINE config 4 row-partitioned
DIST_AMG_DIMS = (256, 256, 256)  # structured AMG-PCG on the z-slab stencil
# the grid of the phases held to the JAX package's distributed counts (a
# 4-device mesh on the CPU, f64, scripts/dist_cpu_counts.py): config 4,
# fused Chebyshev PCG (degree 4, λmax bound DIST_CHEB_LMAX), SA-AMG PCG
# with the host set-up (dist_amg) and the distributed one (dist_amg_blocks),
# and GMRES(30) with restricted Schwarz (dist_schwarz_entry)
DIST_SMALL_DIMS = (64, 64, 64)
DIST_CHEB_LMAX = 2.0  # Gershgorin bound of D⁻¹A for the 7-point Laplacian
DIST_RTOL = 1e-8
DIST_CPU_ITERS = {"config4": 233, "cheb_fused": 63, "amg": 14,
                  "amg_blocks": 14, "schwarz": 99}
DIST_C4_TRUE_MAX = 1e-8  # the gathered solution's true relative residual
DIST_C4_X_TOL = 1e-6  # against the single-card config-4 solution
# the JAX package's own distributed-vs-serial CG agreement (tests/test_dist.py
# test_cg_matches_serial: at most 2 iterations apart)
DIST_SERIAL_ITERS_TOL = 2
DIST_MV_TOL = 1e-12  # k = 4 distributed SpMV and its transpose vs serial
DIST_MV_K = 4
# the distributed layer, part 2a (section 7x): s-step GMRES over the
# ranks' slabs against the single card's fixed work (the same 160 basis
# vectors; the residual norm to the kernel-vs-plain tolerance), and
# AMG-LOBPCG against the single card's e1 (LOBPCG's count may move by one
# with the order of the reductions)
DIST_SSTEP_RTOL = 1e-4
DIST_EIG_ITERS_TOL = 1
# the distributed layer, part 2b (section 7x): config 4 on a (2, 2) rank
# grid, Laplace3D through Domi's MDMap on a (2, 2, 1) grid at
# DIST_AMG_DIMS f32 (true residual ≤ DIST_MD_TRUE_MAX in f64) and at
# DIST_SMALL_DIMS f64 (the JAX package's count on a (2, 2, 1) CPU mesh,
# scripts/dist_cpu_counts.py), and the column-block dense LU at
# DIST_DENSE_N, f64, DIST_DENSE_K right-hand sides, a + n·I from seed 17
DIST_MD_GRID = (2, 2, 1)
DIST_MD_TRUE_MAX = 1e-5
DIST_MD_CPU_ITERS = 59
DIST_DENSE_N = 8192
DIST_DENSE_NB = 128
DIST_DENSE_K = 4
DIST_DENSE_RES_MAX = 1e-12  # ‖a·x − b‖ / ‖b‖
DIST_DENSE_X_TOL = 1e-10  # max|Δx| / max|x| against torch.linalg.solve
# the FE discretisation layer (section 7y): Q1 Poisson on FEM_GRID
# hexahedra; dia_kernel and fe_apply_local against the plain and the
# assembled apply on K_ii, and the manufactured solution's max nodal error
# at h = 1/80 (O(h²): 2.6e-2 at h = 1/8 on the CPU, 1.785e-4 at h = 1/96
# on the card, so about 2.6e-4 here). At 96³ (entry.FEM_DIMS, 857,375
# rows) the host mesh and assembly took 31.6–41.8 s beside the H100, so
# the grid is 80³ (493,039 rows) for the script's time limit
FEM_GRID = (80, 80, 80)
FEM_CHECK_TOL = 1e-12
FEM_NODAL_MAX = 1e-3
# the application layer (section 7z): the kernel wrappers' derivative
# rules at the paths' shapes, JFNK Bratu on the 256³ stencil, the nonlinear
# PDE example, Phalanx, Piro and ROL
RULE_F64_DIMS = (64, 64, 64)  # the f64 stencil of the rule gates
RULE_BDIA_TOL = 1e-5  # BDIA kernel against its plain version (not bitwise)
HVP_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}  # ½(A + Aᵀ)v vs A v
# F(u) = A u − λh²e^u cancels stencil terms of size |u| ≈ 0.27 to a residual
# of size λh² = 6.1e-5 at 256³, so float32 holds F to about 1e-3 of ‖F(0)‖
# (the floor read 8.4e-6, 3.2e-5, 1.2e-4 of ‖F(0)‖ at 32³, 64³, 96³ on the
# CPU, growing as (n+1)²): Newton's target sits above it
BRATU_RTOL = 3e-3
BRATU_X_TOL = 1e-6  # kernel and plain runs' x, max|Δx| / max|x|
NLPDE_NX = 24  # examples/nonlinear_pde.py's grid, float32 as the example
# the port's CPU counts of nonlinear_pde_entry(24) in float32
# (scripts/nonlinear_cpu_counts.py). The example's adaptive march controls
# its local error at rtol 1e-5 (a scale of about 1e-6 on u ≈ 0.08) while
# each stage's Newton stops at ‖R‖ ≤ 1e-5, so the error estimate carries
# where Newton happened to stop, and a 1-ulp change in exp or in a GMRES
# dot moves the step sequence: on the CPU the JAX package's float32 march
# takes 347 steps (6 rejected, 198 Newton iterations) against the port's
# 328 (4, 177), and on the card the port's float64 march took 258 steps
# (118 Newton) against its CPU's 268 (128) on an H100. So
# the steady solve and the continuation are held to the CPU's counts, and
# the march to NLPDE_MARCH_TOL of its steps and Newton iterations and
# NLPDE_MARCH_REJECTED of its rejections, with the settling check
NLPDE_CPU = {"newton_iters": 2, "newton_inner": 50, "cont_points": 11,
             "cont_failed": 0, "cont_newton": 16, "march_steps": 328,
             "march_rejected": 4, "march_newton": 177}
NLPDE_MARCH_TOL = 0.1  # relative, on the march's steps and Newton iterations
NLPDE_MARCH_REJECTED = 2  # ± on its rejected steps
PHALANX_N = 512  # Q1 quadrilaterals a side: 263,169 dofs, f64
PHALANX_FTOL = 1e-8  # ‖F(x)‖ of the Phalanx JFNK solve
PIRO_DIMS = (32, 32, 32)  # the adjoint GMRES takes no preconditioner
PIRO_P = (3.0, 1.0)  # (λ, source amplitude)
PIRO_FD_RTOL = 1e-5  # dg/dp against a central finite difference
PIRO_FD_STEP = 1e-4
OPT_DIMS = (32, 32, 32)  # trust-region Newton on ½xᵀAx − bᵀx, f64
OPT_TRUE_MAX = 1e-7  # its true relative residual ‖b − A x‖ / ‖b‖
LBFGS_N = 2 ** 20  # L-BFGS on the ROL zoo's Rosenbrock, f64
LBFGS_CPU = (35, 64)  # iterations, line-search evaluations: the CPU port's


def mass27_stencil():
    """The tensor Q1 mass stencil M₁⊗M₁⊗M₁, M₁ = tridiag(1, 4, 1)/6: 27
    constant terms (a StencilOp's (offset, coefficient) list)."""
    w = {-1: 1 / 6, 0: 4 / 6, 1: 1 / 6}
    return [((dx, dy, dz), w[dx] * w[dy] * w[dz]) for dz in (-1, 0, 1)
            for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


def laplace_spectrum(dims, mass=False):
    """Eigenvalues of Galeri Laplace3D on ``dims`` whose indices are each
    among the six lowest or six highest, closed form: Σₐ 2 − 2cos(iₐπ/(nₐ+1)),
    or with ``mass`` of the pencil K x = λ M x, M the tensor Q1 mass
    (Σₐ k₁(iₐ) / Πₐ m₁(iₐ), m₁(i) = (4 + 2cos(iπ/(n+1)))/6): the sine
    eigenvectors are shared. Sorted, with multiplicity."""
    idx = [np.unique(np.r_[1:min(n, 6) + 1, max(n - 5, 1):n + 1])
           for n in dims]
    vals = []
    for i in idx[0]:
        for j in idx[1]:
            for k in idx[2]:
                c = [np.cos(t * np.pi / (n + 1))
                     for t, n in zip((i, j, k), dims)]
                lam = sum(2 - 2 * ci for ci in c)
                if mass:
                    lam /= np.prod([(4 + 2 * ci) / 6 for ci in c])
                vals.append(lam)
    return np.sort(vals)


def closed_form(dims, count, largest=False, mass=False):
    """The ``count`` smallest (or largest) eigenvalues, with multiplicity,
    of Laplace3D on ``dims`` (or of its Q1 mass pencil)."""
    lam = laplace_spectrum(dims, mass)
    return lam[::-1][:count] if largest else lam[:count]


def teko_system():
    """The JAX package's Teko test system (blocks 48 + 32, seed 42, f64):
    the four blocks, the dense matrix and the right-hand side."""
    rng = np.random.default_rng(42)
    n0, n1 = 48, 32
    a00 = rng.standard_normal((n0, n0)) * 0.1 + 4 * np.eye(n0)
    a11 = rng.standard_normal((n1, n1)) * 0.1 + 3 * np.eye(n1)
    a01 = rng.standard_normal((n0, n1)) * 0.2
    a10 = rng.standard_normal((n1, n0)) * 0.2
    dense = np.block([[a00, a01], [a10, a11]])
    return (a00, a01, a10, a11), dense, rng.standard_normal(n0 + n1)
BATCH, SAMPLES = 10, 25
# a call slower than SLOW_CALL_MS (the plain versions and library calls at
# the f64 shapes: 13–72 ms) is timed over SLOW_SAMPLES batches instead
SLOW_CALL_MS, SLOW_SAMPLES = 2.0, 5


def log(*parts):
    print(*parts, flush=True)


def fail(msg):
    raise SystemExit(f"FAIL {msg}")


def rel_err(got, want):
    """(max |Δ| / max |want|, max |Δ|)."""
    err = float((got.double() - want.double()).abs().max())
    return err / float(want.double().abs().max()), err


def check(name, got, want, tol):
    rel, err = rel_err(got, want)
    log(f"check {name}: max|Δ|/max|y| = {rel:.3e} (tol {tol:.0e})")
    if not rel <= tol:
        fail(f"{name}: {rel:.3e} > {tol:.0e}")
    return err


def batch_ms(run):
    """CUDA-event milliseconds a call of ``run()``, which makes BATCH
    calls."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / BATCH


def median_ms(run):
    """Median of ``batch_ms(run)`` over SAMPLES batches after one batch
    that only picks the count: SLOW_SAMPLES when it read over
    SLOW_CALL_MS a call."""
    n = SLOW_SAMPLES if batch_ms(run) > SLOW_CALL_MS else SAMPLES
    return statistics.median(batch_ms(run) for _ in range(n))


def time_ms(fn):
    """Per-call median over CUDA-event pairs, each around BATCH
    back-to-back calls, after three warm-up calls (``median_ms``): the
    host path. The events bracket the host's enqueue of every call as well
    as the device's work, so a call whose host side (Python, allocation,
    the ctypes launch) outlasts its kernel reads the host's time, not the
    card's."""
    for _ in range(3):
        fn()

    def run():
        for _ in range(BATCH):
            fn()

    return median_ms(run)


def graph_ms(fn):
    """Device time per call: BATCH calls captured in one CUDA graph (after
    three warm-up calls on a side stream), the per-call median over timed
    replays (``median_ms``). A replay enqueues the captured launches
    without the host's work, so this reads the card, down to the gaps
    between graph nodes (an empty kernel's replay time, ``empty_launch``)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(BATCH):
            fn()
    ms = median_ms(graph.replay)
    del graph
    return ms


def randn(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda", dtype=dtype)


def stencil_conv(op, k=1, dtype=torch.float32):
    """The 3×3×3 convolution that computes the same stencil apply, over a
    batch of k single-channel grids (input (k, 1, nz, ny, nx))."""
    w = torch.zeros((1, 1, 3, 3, 3), device="cuda", dtype=dtype)
    for (dx, dy, dz), c in zip(op.offsets, op.coeffs):
        w[0, 0, dz + 1, dy + 1, dx + 1] = c
    nx, ny, nz = op.dims

    def run(xb):
        return torch.nn.functional.conv3d(xb.view(k, 1, nz, ny, nx), w,
                                          padding=1)

    return run


def dia_as_csr(a):
    """The same DIA matrix as a torch sparse CSR tensor (entries stored
    where the column is in range and the value is nonzero)."""
    n = a.n_rows_pad
    rows = torch.arange(n, device="cuda").repeat(len(a.offsets))
    offs = torch.tensor(a.offsets, device="cuda").repeat_interleave(n)
    cols = rows + offs
    vals = a.data.reshape(-1)
    keep = (cols >= 0) & (cols < n) & (vals != 0)
    coo = torch.sparse_coo_tensor(torch.stack([rows[keep], cols[keep]]),
                                  vals[keep], (n, n)).coalesce()
    return coo.to_sparse_csr()


def bdia_blocks(a):
    """(block rows, block cols, (b, b) blocks) of a BdiaMatrix: every block
    whose column is in range, ordered by block row and then column."""
    nbr = a.nbr_pad
    q = torch.arange(nbr, device="cuda")
    offs = torch.tensor(a.offsets, device="cuda")
    cols = q[:, None] + offs[None, :]  # (nbr, nd), offsets ascending
    keep = (cols >= 0) & (cols < nbr)
    blocks = a.data.permute(3, 0, 1, 2)  # (nbr, nd, b, b)
    return (q[:, None].expand_as(cols)[keep], cols[keep], blocks[keep])


def bdia_as_csr(a):
    """The same BDIA matrix as a torch sparse CSR tensor (nonzero entries of
    the in-range blocks)."""
    b = a.block_size
    brow, bcol, blocks = bdia_blocks(a)
    i = torch.arange(b, device="cuda")
    rows = (brow[:, None, None] * b + i[:, None]).expand_as(blocks)
    cols = (bcol[:, None, None] * b + i[None, :]).expand_as(blocks)
    keep = blocks != 0
    n = a.n_rows_pad
    coo = torch.sparse_coo_tensor(torch.stack([rows[keep], cols[keep]]),
                                  blocks[keep], (n, n)).coalesce()
    return coo.to_sparse_csr()


def bdia_as_bsr(a):
    """The same BDIA matrix as a torch sparse BSR tensor of (b, b) blocks."""
    brow, bcol, blocks = bdia_blocks(a)
    crow = torch.zeros(a.nbr_pad + 1, dtype=torch.int64, device="cuda")
    crow[1:] = torch.cumsum(torch.bincount(brow, minlength=a.nbr_pad), 0)
    return torch.sparse_bsr_tensor(crow, bcol, blocks.contiguous(),
                                   (a.n_rows_pad, a.n_rows_pad))


def bdia_bytes(a, k, x_itemsize=4):
    """Bytes a BDIA apply must move: the planes once, x and y once each."""
    nd, b = len(a.offsets), a.block_size
    return (nd * b * b * a.data.element_size()
            + 2 * b * k * x_itemsize) * a.nbr_pad


def with_floor(g):
    """g plus cholqr's diagonal floor max(10·eps·max|g|, tiny)."""
    fl = torch.clamp(10.0 * torch.finfo(g.dtype).eps * g.abs().max(),
                     min=torch.finfo(g.dtype).tiny)
    return g + fl * torch.eye(g.shape[0], device=g.device, dtype=g.dtype)


def counts(wrappers):
    return {name: fn.launches for name, fn in wrappers.items()}


def zero(wrappers):
    """Set every count to 0, the fused-launch counts of the polynomial
    wrappers too."""
    for fn in wrappers.values():
        fn.launches = 0
        if hasattr(fn, "kernel_launches"):
            fn.kernel_launches = 0


def run_marked(step, args, owner, attr, wrappers):
    """Run ``step(*args)`` with the counts set to 0, recording them at each
    call of ``owner.attr`` (once per iteration or block step: the
    preconditioner, the block projection, the fused iteration). Returns
    (result, wall ms, counts, most common count moves between two marks,
    all moves)."""
    marks = []
    inner = getattr(owner, attr)

    def marked(*a, **k):
        marks.append(tuple(counts(wrappers).values()))
        return inner(*a, **k)

    zero(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(owner, attr, marked):
        res = step(*args)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    gaps = collections.Counter(
        tuple(b - a for a, b in zip(m0, m1))
        for m0, m1 in zip(marks, marks[1:]))
    if not gaps:
        fail(f"a path made fewer than two calls of {attr}")
    per = dict(zip(wrappers, gaps.most_common(1)[0][0]))
    return res, ms, counts(wrappers), per, dict(gaps)


def profile(label, fn, focus=None):
    """Device time by kernel and busy share of one run of ``fn``; with
    ``focus``, also the summed device time and launches of the kernels
    whose names contain it."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_kernel = {e.key: (e.self_device_time_total / 1e3, e.count)
                 for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA}
    busy = sum(ms for ms, _ in by_kernel.values())
    log(f"profiled {label}: {busy:.2f} ms of device time in {wall:.2f} ms "
        f"wall (busy share {busy / wall:.3f}); by kernel:")
    for key, (ms, count) in sorted(by_kernel.items(),
                                   key=lambda kv: -kv[1][0])[:14]:
        log(f"  {ms:8.3f} ms {count:5d} launches  {key[:100]}")
    if focus:
        hits = [v for key, v in by_kernel.items() if focus in key]
        log(f"profiled {label}: {focus} {sum(ms for ms, _ in hits):.3f} ms "
            f"of device time in {sum(n for _, n in hits)} launches")


def device_busy(fn):
    """(device ms, wall ms) of one run of ``fn`` in this process: the summed
    device time of its CUDA kernels under the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total / 1e3 for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)
    return busy, wall


def kernel_timing(kernel, plain, library, shape, nbytes, flops):
    """The kernel row fields a rank measures: graph-replay ms of the kernel,
    its plain version and the library call (or None), its host path."""
    return dict(shape=shape, bytes=nbytes, flops=flops,
                ms=graph_ms(kernel), host_path_ms=time_ms(kernel),
                plain_ms=graph_ms(plain),
                library_ms=graph_ms(library) if library else None)


def application_phase(ctx):
    """Section 7z, the application layer (NOX/LOCA/Tempus, Phalanx, Piro,
    ROL). ``ctx`` holds what the earlier sections built and ``main``'s
    helpers: ``fine`` (the 256³ f32 stencil), ``amg`` (its Jacobi
    hierarchy), ``a1`` (the hierarchy's DIA level 1), ``a0`` (elasticity
    BDIA level 0), ``setup``, ``drive`` and ``plain_run``. Fails on the
    first gate that does not hold; returns what section 8's kernel rows
    take from it."""
    from trilinos_tpu_torch import piro
    from trilinos_tpu_torch.entry import (BRATU_LAMBDA, bratu_entry,
                                          nonlinear_pde_entry, phalanx_amg,
                                          phalanx_entry)
    from trilinos_tpu_torch.galeri import laplace3d
    from trilinos_tpu_torch.ops import (bdia_spmv, bdia_spmv_plain,
                                        bdia_spmv_t_plain, dia_spmm,
                                        dia_spmv, dia_spmv_plain,
                                        dia_spmv_t_plain, stencil_spmv,
                                        stencil_spmv_plain)
    from trilinos_tpu_torch.ops.autodiff import LinearApply
    from trilinos_tpu_torch.optim import lbfgs, trust_region_newton
    from trilinos_tpu_torch.precond import SaAmg

    fine, amg, a1, a0 = ctx["fine"], ctx["amg"], ctx["a1"], ctx["a0"]
    drive, plain_run = ctx["drive"], ctx["plain_run"]
    t_app = time.perf_counter()
    out = {"err": {}}

    def mx(t):
        return float(t.double().abs().max())

    def warm_ms(fn, *args):
        """Wall ms of a second, warm run of fn(*args)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    # -- the derivative rules at the kernels' own shapes -------------------
    fine64 = laplace3d(*RULE_F64_DIMS, dtype=np.float64, fmt="stencil")

    def vecs(a, shape, dt, seed):
        """x, v, w: seeded normals, zero in the pad rows."""
        n = a.n_rows
        vs = []
        for i in range(3):
            t = torch.zeros(shape, dtype=dt, device="cuda")
            t[:n] = randn((n,) + tuple(shape[1:]), dt, seed + i)
            vs.append(t)
        return vs

    gates = [  # label, wrapper, counter, matrix, x shape, dtype, plain,
        # transpose through the Function's backward, bitwise
        (f"stencil_spmv {GRID} f32", stencil_spmv, stencil_spmv, fine,
         (fine.n_rows_pad,), torch.float32, stencil_spmv_plain,
         lambda a, w: stencil_spmv_plain(a.transposed(), w), True),
        (f"stencil_spmv {'x'.join(map(str, RULE_F64_DIMS))} f64",
         stencil_spmv, stencil_spmv, fine64, (fine64.n_rows_pad,),
         torch.float64, stencil_spmv_plain,
         lambda a, w: stencil_spmv_plain(a.transposed(), w), True),
        ("dia_spmv level 1 k=1 f32", dia_spmv, dia_spmv, a1,
         (a1.n_rows_pad,), torch.float32, dia_spmv_plain, dia_spmv_t_plain,
         True),
        ("dia_spmm level 1 k=4 f32", dia_spmm, dia_spmm, a1,
         (a1.n_rows_pad, 4), torch.float32, dia_spmv_plain,
         dia_spmv_t_plain, True),
        ("bdia_spmv elasticity level 0 f32", bdia_spmv, bdia_spmv, a0,
         (a0.n_rows_pad,), torch.float32, bdia_spmv_plain,
         bdia_spmv_t_plain, False)]
    for i, (label, wrap, counter, a, shape, dt, plain, trans, exact) in \
            enumerate(gates):
        x, v, w = vecs(a, shape, dt, 700 + 3 * i)
        before = counter.launches
        y, tan = torch.func.jvp(lambda z: wrap(a, z), (x,), (v,))
        jvp_launches = counter.launches - before
        direct = wrap(a, v)
        _, tan_plain = torch.func.jvp(lambda z: plain(a, z), (x,), (v,))
        _, pull = torch.func.vjp(lambda z: wrap(a, z), x)
        cot = pull(w)[0]
        cot_want = trans(a, w)

        def q(z):
            return 0.5 * (z * wrap(a, z)).sum()

        hv = torch.func.jvp(torch.func.grad(q), (x,), (v,))[1]
        errs = (mx(tan - direct), mx(tan - tan_plain), mx(cot - cot_want))
        hv_rel = mx(hv - direct) / mx(direct)
        out["err"][label] = errs[1]
        log(f"rule {label}: JVP launches {jvp_launches}; tangent vs the "
            f"wrapper on v max|Δ| {errs[0]:.3e}, vs the plain version's JVP "
            f"{errs[1]:.3e}; VJP cotangent vs the transpose apply "
            f"{errs[2]:.3e}; forward-over-reverse hvp of ½xᵀAx vs A v "
            f"max|Δ|/max|Av| {hv_rel:.3e}"
            + (" (bitwise)" if exact and not any(errs) else ""))
        if jvp_launches != 2:
            fail(f"rule {label}: a JVP launched {jvp_launches} kernels, not 2")
        tol = 0.0 if exact else RULE_BDIA_TOL * mx(direct)
        if max(errs) > tol:
            fail(f"rule {label}: {errs} past {tol:.1e}")
        if not hv_rel <= HVP_TOL[dt]:
            fail(f"rule {label}: hvp {hv_rel:.3e} > {HVP_TOL[dt]:.0e}")
        del x, v, w, y, tan, direct, tan_plain, cot, cot_want, hv
    del fine64

    # -- JFNK Bratu on the 256³ stencil with the CG path's hierarchy -------
    bstep, (bu0, bst) = bratu_entry(DIMS, amg=amg, rtol=BRATU_RTOL)
    kern = {"stencil_spmv": stencil_spmv, "dia_spmv": dia_spmv}
    zero(kern)
    vres = amg.apply_state(bst, randn(fine.n_rows_pad, torch.float32, 790))
    vcycle = counts(kern)
    del vres
    calls = {"prec": 0}
    inner_apply = SaAmg.apply_state

    def counted(*a, **k):
        calls["prec"] += 1
        return inner_apply(*a, **k)

    f0 = float(torch.linalg.vector_norm(bstep.residual(bu0)))
    jvps0 = LinearApply.jvp_calls
    torch.cuda.reset_peak_memory_stats()
    in_use = torch.cuda.memory_allocated()
    with mock.patch.object(SaAmg, "apply_state", counted):
        bres, bms, blaunch = drive(bstep, (bu0, bst))
    peak = (torch.cuda.max_memory_allocated() - in_use) / 2 ** 30
    jvps = LinearApply.jvp_calls - jvps0
    n_res = blaunch.get("stencil_spmv", 0) - 2 * jvps - calls["prec"] * \
        vcycle["stencil_spmv"]
    bref, bplain_ms = plain_run(bstep, bu0, bst)
    rel_x, _ = rel_err(bres.x, bref.x)
    mask = torch.zeros(fine.n_rows_pad, dtype=torch.float64, device="cuda")
    mask[:fine.n_rows] = 1.0
    x64 = bres.x.double()
    f_true = float(torch.linalg.vector_norm(
        stencil_spmv_plain(fine, x64)
        - BRATU_LAMBDA * bstep.h2 * mask * torch.exp(x64)))
    target = BRATU_RTOL * f0
    bwarm = warm_ms(bstep, bu0, bst)
    busy, wall = device_busy(lambda: bstep(bu0, bst))
    log(f"JFNK Bratu {GRID} f32 (λ = {BRATU_LAMBDA}, h² = 1/{DIMS[0] + 1}², "
        f"type2 forcing, polynomial line search, AMG-right-preconditioned "
        f"GMRES(30), rtol {BRATU_RTOL:g}): converged {bres.converged}, "
        f"{bres.iters} Newton, {bres.inner_iters} GMRES iterations "
        f"(plain versions: {bref.iters}, {bref.inner_iters}); "
        f"max|Δx|/max|x| against the plain run {rel_x:.3e} (bitwise "
        f"{torch.equal(bres.x, bref.x)}); ‖F(x)‖ in f64 {f_true:.4e}, "
        f"Newton's {bres.fnorm:.4e}, target {target:.4e} (‖F(0)‖ "
        f"{f0:.4e}); max u {float(bres.x.max()):.4f}")
    log(f"JFNK Bratu {GRID}: first solve {bms:.1f} ms, warm {bwarm:.1f} ms, "
        f"{bwarm / max(bres.iters, 1):.2f} ms a Newton step, "
        f"{bwarm / max(bres.inner_iters, 1):.2f} ms a GMRES iteration "
        f"(plain versions {bplain_ms:.1f} ms); busy share {busy / wall:.3f} "
        f"({busy:.1f} ms of device time in {wall:.1f} ms); the solve's own "
        f"peak device memory {peak:.3f} GiB; launches a solve {blaunch}: "
        f"{jvps} JVPs (2 launches each), {calls['prec']} V-cycles "
        f"({vcycle} each), {n_res} residual evaluations")
    if not (bres.converged and bref.converged):
        fail("JFNK Bratu did not converge")
    if (bres.iters, bres.inner_iters) != (bref.iters, bref.inner_iters):
        fail(f"JFNK Bratu counts {bres.iters}/{bres.inner_iters} against the "
             f"plain versions' {bref.iters}/{bref.inner_iters}")
    if not rel_x <= BRATU_X_TOL:
        fail(f"JFNK Bratu x: {rel_x:.3e} > {BRATU_X_TOL:.0e}")
    if not f_true <= target:
        fail(f"JFNK Bratu true ‖F‖ {f_true:.3e} > target {target:.3e}")
    if not (blaunch.get("stencil_spmv") and blaunch.get("dia_spmv")):
        fail(f"JFNK Bratu launched {blaunch}")
    if n_res < 1 + 2 * bres.iters:
        fail(f"JFNK Bratu: {n_res} stencil launches left for residuals")
    v0 = randn(fine.n_rows_pad, torch.float32, 791)
    x0 = randn(fine.n_rows_pad, torch.float32, 792)
    out["bratu"] = dict(launches=blaunch, iters=bres.iters,
                        inner=bres.inner_iters, jvp_host_path_ms=time_ms(
                            lambda: torch.func.jvp(
                                lambda z: stencil_spmv(fine, z), (x0,),
                                (v0,))))
    log(f"stencil_spmv JVP (primal and tangent, 2 launches) {GRID} f32: "
        f"{out['bratu']['jvp_host_path_ms']:.4f} ms host path, bound "
        f"{2 * 2 * fine.n_rows_pad * 4 / HBM_BYTES_PER_MS:.4f} ms")
    del bres, bref, x64, mask, v0, x0

    # -- examples/nonlinear_pde.py on the card (float32) --------------------
    zero(kern)
    t0 = time.perf_counter()
    nl = nonlinear_pde_entry(NLPDE_NX)
    torch.cuda.synchronize()
    nl_s = time.perf_counter() - t0
    got = {k: nl[k] for k in NLPDE_CPU}
    log(f"nonlinear PDE (examples/nonlinear_pde.py) {NLPDE_NX}² f32: {got} "
        f"(CPU: {NLPDE_CPU}); continuation to λ {nl['cont_max_lambda']:.3f}, "
        f"max u {nl['cont_max_u']:.4f}; march max u {nl['march_max_u']:.4f}, "
        f"drift {nl['drift']:.2e}; {nl_s:.2f} s; launches {counts(kern)}")
    for k in ("march_steps", "march_newton"):
        if abs(got[k] - NLPDE_CPU[k]) > NLPDE_MARCH_TOL * NLPDE_CPU[k]:
            fail(f"nonlinear PDE {k} {got[k]} against the CPU's "
                 f"{NLPDE_CPU[k]}")
    if abs(got["march_rejected"] - NLPDE_CPU["march_rejected"]) > \
            NLPDE_MARCH_REJECTED:
        fail(f"nonlinear PDE march rejections {got}")
    if any(got[k] != NLPDE_CPU[k] for k in NLPDE_CPU
           if not k.startswith("march")):
        fail(f"nonlinear PDE counts {got} against the CPU's {NLPDE_CPU}")
    if not (dia_spmv.launches and nl["drift"] < 1e-2):
        fail("nonlinear PDE: no dia_kernel launch or the march did not "
             "settle")

    # -- Phalanx: JFNK nonlinear Poisson on PHALANX_N² Q1 quadrilaterals ----
    pam, pam_s = ctx["setup"](f"Phalanx K_ii {PHALANX_N}² uncoupled AMG",
                              lambda: phalanx_amg(PHALANX_N))
    t0 = time.perf_counter()
    pstep, (pu0, pst) = phalanx_entry(PHALANX_N, amg=pam)
    torch.cuda.synchronize()
    pb_s = time.perf_counter() - t0
    kii = pam.fine_op
    xk = randn(kii.n_rows_pad, torch.float64, 793)
    out["err"]["phalanx K_ii"] = check(
        f"dia, Phalanx K_ii {PHALANX_N}² ({kii.n_rows} rows x "
        f"{len(kii.offsets)} diags) f64", dia_spmv(kii, xk),
        dia_spmv_plain(kii, xk), 0.0)
    pres, pms, plaunch = drive(pstep, (pu0, pst))
    pref, pplain_ms = plain_run(pstep, pu0, pst)
    p_f = float(torch.linalg.vector_norm(pstep.residual(pres.x)))
    pwarm = warm_ms(pstep, pu0, pst)
    log(f"Phalanx JFNK -div((1+u²)∇u) = 4 on {PHALANX_N}² Q1 "
        f"({pstep.block.n_dof} dofs, f64): workset {pb_s:.2f} s, AMG "
        f"{pam_s:.2f} s; converged {pres.converged}, {pres.iters} Newton, "
        f"{pres.inner_iters} GMRES iterations (plain versions {pref.iters}, "
        f"{pref.inner_iters}); ‖F(x)‖ {p_f:.3e}; first solve {pms:.1f} ms, "
        f"warm {pwarm:.1f} ms (plain versions {pplain_ms:.1f} ms); max u "
        f"{float(pres.x.max()):.4f}; launches {plaunch}")
    if not (pres.converged and p_f <= PHALANX_FTOL):
        fail(f"Phalanx JFNK: converged {pres.converged}, ‖F‖ {p_f:.3e}")
    if (pres.iters, pres.inner_iters) != (pref.iters, pref.inner_iters):
        fail("Phalanx JFNK: kernel and plain counts differ")
    if not plaunch.get("dia_spmv"):
        fail("Phalanx JFNK: dia_kernel was never launched")
    out["phalanx"] = dict(a=kii, x=xk, launches=plaunch.get("dia_spmv", 0),
                          gmres=pres.inner_iters)
    del pres, pref, pstep

    # -- Piro on the PIRO_DIMS stencil Bratu, p = (λ, source amplitude) -----
    op32 = laplace3d(*PIRO_DIMS, dtype=np.float64, fmt="stencil")
    n32, np32 = op32.n_rows, op32.n_rows_pad
    h2 = 1.0 / (PIRO_DIMS[0] + 1) ** 2
    m32 = torch.zeros(np32, dtype=torch.float64, device="cuda")
    m32[:n32] = 1.0
    target = 0.05 * m32

    def pres_fn(u, p):
        return stencil_spmv(op32, u) - h2 * m32 * (p[0] * torch.exp(u) + p[1])

    model = piro.Model(pres_fn,
                       lambda u, p: 0.5 * torch.sum((u - target) ** 2))
    a32 = SaAmg(op32, {"dtype": np.float64}, device="cuda").compute()
    st32 = a32.state()
    nk = dict(prec_factory=lambda x: (lambda v: a32.apply_state(st32, v)),
              inner_maxiter=3000)
    p = torch.tensor(PIRO_P, dtype=torch.float64, device="cuda")
    u0 = torch.zeros(np32, dtype=torch.float64, device="cuda")
    zero(kern)
    t0 = time.perf_counter()
    sres = piro.solve_steady(model, u0, p, sensitivities=True, rtol=1e-12,
                             adjoint_rtol=1e-10, **nk)
    torch.cuda.synchronize()
    s_ms = (time.perf_counter() - t0) * 1e3
    s_launch = counts(kern)
    fd = []
    for k in range(2):
        gs = []
        for sgn in (1.0, -1.0):
            pk = p.clone()
            pk[k] += sgn * PIRO_FD_STEP * max(1.0, abs(PIRO_P[k]))
            gs.append(float(piro.solve_steady(model, sres.u, pk, rtol=1e-12,
                                              **nk).g))
        fd.append((gs[0] - gs[1]) / (2 * PIRO_FD_STEP
                                     * max(1.0, abs(PIRO_P[k]))))
    dg = sres.dgdp.cpu().numpy()
    fd_rel = float(np.abs(dg - fd).max() / np.abs(fd).max())
    log(f"Piro {'x'.join(map(str, PIRO_DIMS))} f64 Bratu, p = {PIRO_P}: "
        f"converged {sres.converged}, {sres.iters} Newton, "
        f"{sres.inner_iters} GMRES (AMG) iterations; adjoint GMRES "
        f"(unpreconditioned, VJP rule) {sres.adjoint_iters} iterations; "
        f"g {float(sres.g):.6e}; dg/dp {dg} against the central difference "
        f"{np.asarray(fd)}: max rel {fd_rel:.3e} (gate {PIRO_FD_RTOL:.0e}); "
        f"{s_ms:.1f} ms; launches {s_launch}")
    if not sres.converged or not fd_rel <= PIRO_FD_RTOL:
        fail(f"Piro: converged {sres.converged}, dg/dp {fd_rel:.3e}")
    if not s_launch.get("stencil_spmv"):
        fail("Piro: stencil_kernel was never launched")
    zero(kern)
    t0 = time.perf_counter()
    tres, tg = piro.solve_transient(model, u0, p, 0.0, 0.05, 0.01)
    torch.cuda.synchronize()
    log(f"Piro transient du/dt = -F(u, p) to t = 0.05: {tres.steps} steps "
        f"({tres.rejected} rejected), {tres.newton_iters} Newton iterations, "
        f"g(u(t)) {float(tg):.6e}, {(time.perf_counter() - t0) * 1e3:.1f} "
        f"ms; launches {counts(kern)}")
    if not (tres.steps >= 2 and abs(tres.t - 0.05) < 1e-12
            and np.isfinite(float(tg))):
        fail(f"Piro transient: {tres.steps} steps to t = {tres.t}")
    del sres, tres, a32, st32

    # -- ROL: trust-region Newton-CG on ½xᵀAx − bᵀx (hvp by the rules) ------
    opt = laplace3d(*OPT_DIMS, dtype=np.float64, fmt="stencil")
    bq = torch.zeros(opt.n_rows_pad, dtype=torch.float64, device="cuda")
    bq[:opt.n_rows] = randn(opt.n_rows, torch.float64, 794)
    bnorm = float(torch.linalg.vector_norm(bq))
    zero(kern)
    bw0 = LinearApply.backward_calls
    t0 = time.perf_counter()
    ores = trust_region_newton(
        lambda x: 0.5 * torch.dot(x, stencil_spmv(opt, x)) - torch.dot(bq, x),
        torch.zeros_like(bq), gtol=1e-9 * bnorm, maxiter=200,
        cg_maxiter=1000)
    torch.cuda.synchronize()
    o_ms = (time.perf_counter() - t0) * 1e3
    o_true = float(torch.linalg.vector_norm(
        bq - stencil_spmv_plain(opt, ores.x))) / bnorm
    log(f"ROL trust-region Newton-CG on ½xᵀAx − bᵀx, A the "
        f"{'x'.join(map(str, OPT_DIMS))} f64 stencil: converged "
        f"{ores.converged}, {ores.iters} outer, {ores.inner_iters} CG "
        f"iterations, {LinearApply.backward_calls - bw0} backward rules; "
        f"true relative residual {o_true:.3e} (gate {OPT_TRUE_MAX:.0e}); "
        f"{o_ms:.1f} ms; launches {counts(kern)}")
    if not (ores.converged and o_true <= OPT_TRUE_MAX):
        fail(f"ROL trust region: true residual {o_true:.3e}")
    if not stencil_spmv.launches:
        fail("ROL trust region: stencil_kernel was never launched")
    xr = torch.tensor([-1.2, 1.0], dtype=torch.float64,
                      device="cuda").repeat(LBFGS_N // 2)
    t0 = time.perf_counter()
    lres = lbfgs(lambda x: torch.sum(100.0 * (x[1::2] - x[::2] ** 2) ** 2
                                     + (1.0 - x[::2]) ** 2), xr, gtol=1e-6,
                 maxiter=500)
    torch.cuda.synchronize()
    log(f"ROL L-BFGS on Rosenbrock n = {LBFGS_N} f64: converged "
        f"{lres.converged}, {lres.iters} iterations, {lres.inner_iters} "
        f"line-search evaluations (CPU: {LBFGS_CPU}); max|x − 1| "
        f"{mx(lres.x - 1.0):.3e}; {(time.perf_counter() - t0) * 1e3:.1f} ms")
    if (lres.iters, lres.inner_iters) != LBFGS_CPU or not lres.converged:
        fail(f"ROL L-BFGS {lres.iters}/{lres.inner_iters} against the CPU's "
             f"{LBFGS_CPU}")
    del ores, lres, xr, bq
    log(f"application phase: {time.perf_counter() - t_app:.1f} s with its "
        "set-up")
    return out


def application_only():
    """``application_phase`` alone (``scripts/chip_application.py``): the
    kernels built, then what the phase takes from the earlier sections as
    ``main`` builds it (the DIMS stencil and its Jacobi hierarchy; the
    elasticity matrix on EL_DIMS nodes as BDIA, which is block AMG's level
    0) and ``main``'s helpers for the phase's kernels."""
    from trilinos_tpu_torch.galeri import elasticity3d, laplace3d
    from trilinos_tpu_torch.ops import (_build, bdia_spmv, bdia_spmv_plain,
                                        csr_to_bdia, dia_spmv, dia_spmv_plain,
                                        matvec, spgemm, stencil_spmv,
                                        stencil_spmv_plain)
    from trilinos_tpu_torch.precond import SaAmg

    t0 = time.perf_counter()
    _build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s")
    kernels = {"stencil_spmv": stencil_spmv, "dia_spmv": dia_spmv,
               "bdia_spmv": bdia_spmv}

    def setup(label, fn):
        spgemm.native_calls = spgemm.numpy_calls = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        log(f"setup {label}: {secs:.2f} s; SpGEMM products: native "
            f"{spgemm.native_calls}, numpy {spgemm.numpy_calls}")
        if spgemm.numpy_calls or not spgemm.native_calls:
            fail(f"setup {label}: the native SpGEMM did not serve it")
        return out, secs

    def drive(step, args):
        zero(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(*args)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3, {
            k: v for k, v in counts(kernels).items() if v}

    def plain_run(fn, *args):
        before = counts(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            for attr, plain in (("stencil_spmv", stencil_spmv_plain),
                                ("dia_spmv", dia_spmv_plain),
                                ("bdia_spmv", bdia_spmv_plain)):
                stack.enter_context(mock.patch.object(matvec, attr, plain))
            out = fn(*args)
        torch.cuda.synchronize()
        if counts(kernels) != before:
            fail("a plain reference run launched a kernel")
        return out, (time.perf_counter() - t0) * 1e3

    fine = laplace3d(*DIMS, dtype=np.float32, fmt="stencil")
    amg, _ = setup(f"{GRID} hierarchy", lambda: SaAmg(
        fine, {"dtype": np.float32}, device="cuda").compute())
    a0 = csr_to_bdia(elasticity3d(*EL_DIMS, e_mod=1.0, dtype=np.float32), 3,
                     dtype=np.float32, device="cuda")
    return application_phase(dict(
        fine=fine, amg=amg, a1=amg.state()["levels"][1]["a"], a0=a0,
        setup=setup, drive=drive, plain_run=plain_run))


def dist_rank_phases(comm, device, c4_dims, amg_dims, small_dims):
    """Body of each rank of section 7x (one process a rank on the card):
    config 4 row-partitioned at c4_dims and small_dims, the k = 4
    distributed SpMV and its transpose, structured AMG-PCG on the z-slab
    stencil at amg_dims, on small_dims fused-Chebyshev PCG and SA-AMG PCG
    with both set-ups, then s-step GMRES and AMG-LOBPCG at amg_dims and
    Schwarz GMRES at c4_dims and small_dims, config 4 on a (2, 2) rank
    grid, Laplace3D on a DIST_MD_GRID rank grid through Domi's MDMap at
    amg_dims (f32) and small_dims (f64), and the column-block dense LU.
    Each solve runs with the counts at 0 just before and read just after;
    each kernel of a path is held against its plain version on this rank's
    data first. Rank 0 then times the kernels at the ranks' shapes while
    the others wait."""
    from trilinos_tpu_torch.entry import (dist_amg_entry, dist_eigen_entry,
                                          dist_md_entry,
                                          dist_pipelined_cg_entry,
                                          dist_schwarz_entry,
                                          dist_sstep_entry, dryrun_rank)
    from trilinos_tpu_torch.galeri import laplace3d
    from trilinos_tpu_torch.galeri.stencils import cross3d_stencil
    from trilinos_tpu_torch.ops.stencil_op import StencilOp
    from trilinos_tpu_torch.parallel.mdarray import halo_pad
    from trilinos_tpu_torch.solvers import dist_dense_solve
    from trilinos_tpu_torch.ops import (chol_inv_small, dia_spmm, dia_spmv,
                                        dia_spmv_plain, stencil_poly_apply,
                                        stencil_poly_plain,
                                        stencil_powers_apply,
                                        stencil_powers_plain, stencil_spmm,
                                        stencil_spmv, stencil_spmv_plain)
    from trilinos_tpu_torch.ops.stencil_poly import monomial_stages
    from trilinos_tpu_torch.parallel import dist_setup
    from trilinos_tpu_torch.parallel import distmatrix as D
    from trilinos_tpu_torch.parallel import driver as drv
    from trilinos_tpu_torch.solvers import cg

    kern = {"dia_spmv": dia_spmv, "dia_spmm": dia_spmm,
            "stencil_spmv": stencil_spmv, "stencil_poly": stencil_poly_apply,
            "stencil_powers": stencil_powers_apply,
            "stencil_spmm": stencil_spmm, "chol_inv_small": chol_inv_small}
    me, p = comm.index(), comm.size
    out = {}

    def chunk(rmap, host, dtype=torch.float64):
        return torch.from_numpy(rmap.local_chunk(
            rmap.to_padded(host), me).copy()).to(device, dtype)

    def run(label, step, *args, via=None, **kw):
        """One solve with the counts at 0 just before and read just after;
        the result's plain fields go to out[label]. ``via``: the comm whose
        staged bytes the solve reads (the rank's group by default)."""
        via = via or comm
        zero(kern)
        via.staged_bytes = 0
        torch.cuda.synchronize()
        comm.barrier()
        t0 = time.perf_counter()
        res = step(*args, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        out[label] = dict(iters=int(res.iters), ms=ms,
                          launches=counts(kern), staged=via.staged_bytes,
                          kernel_launches=stencil_powers_apply.kernel_launches)
        if hasattr(res, "resnorm"):
            out[label].update(resnorm=float(res.resnorm),
                              converged=bool(res.converged))
        else:  # an eigensolve
            out[label].update(vals=res.eigenvalues, resnorms=res.resnorms)
        return res

    def bitwise(label, got, want):
        out.setdefault("err", {})[label] = float((got - want).abs().max())

    # config 4 row-partitioned, 128³ f64: DIA interiors, halo-overlap apply
    t0 = time.perf_counter()
    step, (b,) = dist_pipelined_cg_entry(c4_dims, n_ranks=p, comm=comm,
                                         device=device)
    setup_s = time.perf_counter() - t0
    al = step.matrix
    bitwise("c4 interior", dia_spmv(al.interior, b),
            dia_spmv_plain(al.interior, b))
    res = run("c4", step, b)
    out["c4"].update(x=res.x, setup_s=setup_s, mode=al.plan.mode,
                     halo_rows=int(al.plan.ghost_valid.sum()),
                     rows=al.interior.n_rows_pad,
                     diags=len(al.interior.offsets))
    comm.staged_bytes = 0
    comm.barrier()
    busy, wall = device_busy(lambda: step(b))
    out["c4"].update(busy_ms=busy, warm_ms=wall,
                     warm_staged=comm.staged_bytes)
    # the k = 4 distributed SpMV and its transpose against the serial one
    n4 = al.row_map.n_global
    xk = chunk(al.row_map, np.random.default_rng(11).standard_normal(
        (n4, DIST_MV_K)))
    out["mv"] = dict(y=drv.dist_spmv(al, xk, comm),
                     yt=drv.dist_spmv_t(al, xk, comm))
    c4_timing = None
    if me == 0:
        csr = dia_as_csr(al.interior)
        nnz = int((al.interior.data != 0).sum())
        c4_timing = kernel_timing(
            lambda: dia_spmv(al.interior, b),
            lambda: dia_spmv_plain(al.interior, b), lambda: csr @ b,
            f"rank-local interior of config 4 at {p} ranks: "
            f"{al.interior.n_rows_pad} rows x {len(al.interior.offsets)} "
            f"diags f64", (len(al.interior.offsets) + 2)
            * al.interior.n_rows_pad * 8, 2 * nnz)
    comm.barrier()
    # (a) config 4 again on a (2, 2) rank grid of the same ranks: the rows
    # run over the grid's flattened ranks, so the flat layout's iterations
    # and x come back bit for bit
    t0 = time.perf_counter()
    grid = drv.make_mesh2(comm, 2, p // 2)
    gstep, (gb,) = dist_pipelined_cg_entry(c4_dims, comm=grid, device=device)
    setup_s = time.perf_counter() - t0
    gres = run("c4_grid", gstep, gb, via=grid)
    out["c4_grid"].update(
        setup_s=setup_s, axes=drv.solve_axes(grid), coords=grid.coords,
        x_diff=float((gres.x - out["c4"]["x"]).abs().max()),
        b_diff=float((gb - b).abs().max()))
    del step, al, b, xk, gstep, gb, gres

    # config 4 at the small grid, held to the JAX package's count
    step, (b,) = dist_pipelined_cg_entry(small_dims, n_ranks=p, comm=comm,
                                         device=device)
    run("c4_small", step, b)
    del step, b

    # structured AMG-PCG on the z-slab stencil, 256³ f32
    t0 = time.perf_counter()
    step, (b,) = dist_amg_entry(amg_dims, n_ranks=p, comm=comm,
                                device=device)
    setup_s = time.perf_counter() - t0
    op_s = step.operator
    ext = D.gather_extended(op_s.sel, op_s.valid, op_s.plan, b, comm)
    bitwise("amg slab stencil", stencil_spmv(op_s.op_local, ext),
            stencil_spmv_plain(op_s.op_local, ext))
    run("amg", step, b)
    out["amg"].update(setup_s=setup_s, mode=op_s.plan.mode,
                      halo_rows=int(op_s.plan.ghost_valid.sum()),
                      slab=op_s.op_local.dims)
    amg_timing = None
    if me == 0:
        conv = stencil_conv(op_s.op_local)
        n_ext = op_s.op_local.n_rows_pad
        amg_timing = kernel_timing(
            lambda: stencil_spmv(op_s.op_local, ext),
            lambda: stencil_spmv_plain(op_s.op_local, ext),
            lambda: conv(ext),
            "extended slab " + "x".join(map(str, op_s.op_local.dims))
            + f" f32 (one rank of {p} at {'x'.join(map(str, amg_dims))})",
            2 * n_ext * 4, 2 * op_s.op_local.nnz)
    comm.barrier()
    del step, b, ext, op_s

    # fused Chebyshev PCG on the small grid, f64: one depth-4 exchange and
    # one stencil_poly_apply an apply
    op = laplace3d(*small_dims, dtype=np.float64, fmt="stencil")
    ds = D.distribute_stencil(op, p)
    sl = ds.local(me, device)
    pc = drv.dist_cheb_fused(op, p, degree=4, lmax=DIST_CHEB_LMAX,
                             device=device)
    lp = pc.local(me, device)
    m = lp.make(comm, drv.local_op(sl, comm))
    b = chunk(ds.row_map, np.random.default_rng(1).standard_normal(
        op.n_rows))
    stages, op_c, _, _ = pc.consts
    ext = D.gather_extended(lp.local["sel"], lp.local["valid"],
                            lp.local["plan"], b, comm)
    zb = tuple(lp.local["zb"].tolist())
    bitwise("cheb_fused slab polynomial",
            stencil_poly_apply(op_c, stages, ext, z_bounds=zb),
            stencil_poly_plain(op_c, stages, ext, zb))
    run("cheb_fused", drv.dist_solve, cg, sl, b, comm=comm, prec=m,
        rtol=DIST_RTOL, maxiter=500)
    poly_timing = None
    if me == 0:
        n_ext = op_c.n_rows_pad
        poly_timing = kernel_timing(
            lambda: stencil_poly_apply(op_c, stages, ext, z_bounds=zb),
            lambda: stencil_poly_plain(op_c, stages, ext, zb), None,
            "extended slab " + "x".join(map(str, op_c.dims))
            + f" f64, Chebyshev s={len(stages)} with z-bounds {zb} (rank 0)",
            2 * n_ext * 8, sum((2 * op_c.nnz + n_ext if a else 0)
                               + 2 * n_ext * ((bt != 0) + (g != 0)
                                              + (z != 0))
                               for a, bt, g, z in stages))
    comm.barrier()

    # SA-AMG PCG on the stored small grid: host and distributed set-ups
    a = laplace3d(*small_dims)
    dm = D.distribute(a, p)
    am = dm.local(me, device)
    b = chunk(dm.row_map, np.random.default_rng(1).standard_normal(
        a.shape[0]))
    for label, make in (
            ("amg_host", lambda: drv.dist_amg(a, dm.row_map)),
            ("amg_blocks", lambda: drv.dist_amg_blocks(
                dist_setup.split_rows(a, dm.row_map), dm.row_map))):
        t0 = time.perf_counter()
        pcm = make()
        setup_s = time.perf_counter() - t0
        run(label, drv.dist_solve, cg, am, b, comm=comm, prec=pcm,
            rtol=DIST_RTOL)
        out[label].update(setup_s=setup_s,
                          levels=len(pcm.arrays["levels"]) + 1)
    # s-step GMRES at amg_dims f32, the single card's fixed work: one
    # depth-4 exchange and one stencil_powers_apply on this rank's extended
    # slab a block step
    t0 = time.perf_counter()
    step, (b,) = dist_sstep_entry(amg_dims, n_ranks=p, comm=comm,
                                  device=device)
    setup_s = time.perf_counter() - t0
    op = step.operator
    depth = 4  # s · the z-reach of the 7-point cross
    ss = D.distribute_stencil(op, p, depth=depth).local(me, device)
    zb_s = tuple(int(z) for z in D.zslab_bounds(op, p, depth)[me])
    mono4 = monomial_stages(4, 12.0)
    ext = D.gather_extended(ss.sel, ss.valid, ss.plan, b, comm)
    bitwise("sstep slab powers",
            stencil_powers_apply(ss.op_local, mono4, ext, z_bounds=zb_s),
            stencil_powers_plain(ss.op_local, mono4, ext, zb_s))
    run("sstep", step, b)
    out["sstep"].update(setup_s=setup_s, slab=ss.op_local.dims, zb=zb_s)
    sstep_timing = None
    if me == 0:
        n_ext = ss.op_local.n_rows_pad
        sstep_timing = kernel_timing(
            lambda: stencil_powers_apply(ss.op_local, mono4, ext,
                                         z_bounds=zb_s),
            lambda: stencil_powers_plain(ss.op_local, mono4, ext, zb_s),
            None, "extended slab " + "x".join(map(str, ss.op_local.dims))
            + f" f32, monomial s=4, all outputs, z-bounds {zb_s} (rank 0 "
            f"of {p})", (1 + 4) * n_ext * 4,
            4 * (2 * ss.op_local.nnz + n_ext))
    comm.barrier()
    del step, b, ext, ss

    # LOBPCG (nev EIG_NEV, SM) with the distributed structured AMG at
    # amg_dims f64: the block apply on this rank's slab (stencil_mv_kernel)
    # and the replicated coarse levels (dia_mv_kernel)
    t0 = time.perf_counter()
    step, _ = dist_eigen_entry(amg_dims, nev=EIG_NEV, n_ranks=p, comm=comm,
                               device=device)
    setup_s = time.perf_counter() - t0
    op_e = step.operator
    x4 = randn((op_e.row_map.n_local_pad, EIG_NEV), torch.float64,
               seed=70 + me)
    ext4 = D.gather_extended(op_e.sel, op_e.valid, op_e.plan, x4, comm)
    bitwise("eigen slab stencil SpMM", stencil_spmm(op_e.op_local, ext4),
            stencil_spmv_plain(op_e.op_local, ext4))
    a1 = step.preconditioner.replicated["inner"][0]["a"]
    y4 = randn((a1.n_rows_pad, EIG_NEV), torch.float64, seed=80 + me)
    bitwise("eigen coarse DIA SpMM", dia_spmm(a1, y4),
            dia_spmv_plain(a1, y4))
    run("eigen", step)
    out["eigen"].update(setup_s=setup_s, slab=op_e.op_local.dims)
    eig_timing = None
    if me == 0:
        conv4 = stencil_conv(op_e.op_local, k=EIG_NEV, dtype=torch.float64)
        n_ext = op_e.op_local.n_rows_pad
        x4b = ext4.T.contiguous()  # the batch layout of conv3d
        eig_timing = kernel_timing(
            lambda: stencil_spmm(op_e.op_local, ext4),
            lambda: stencil_spmv_plain(op_e.op_local, ext4),
            lambda: conv4(x4b),
            "extended slab " + "x".join(map(str, op_e.op_local.dims))
            + f" f64, k={EIG_NEV} (LOBPCG, rank 0 of {p})",
            2 * n_ext * EIG_NEV * 8, 2 * op_e.op_local.nnz * EIG_NEV)
    comm.barrier()
    del step, op_e, x4, ext4, a1, y4

    # GMRES(30) with restricted Schwarz (overlap 1, ILU(0) subdomains) on
    # config 4's matrix at c4_dims and at small_dims, f64
    for label, dims in (("schwarz", c4_dims), ("schwarz_small", small_dims)):
        t0 = time.perf_counter()
        step, (b,) = dist_schwarz_entry(dims, n_ranks=p, comm=comm,
                                        device=device)
        setup_s = time.perf_counter() - t0
        al = step.matrix
        bitwise(f"{label} interior", dia_spmv(al.interior, b),
                dia_spmv_plain(al.interior, b))
        res = run(label, step, b)
        out[label].update(setup_s=setup_s, x=res.x if dims == c4_dims
                          else None)
        del step, b, al, res
    # (b) Laplace3D on a DIST_MD_GRID rank grid through Domi's MDMap: CG
    # with the CA Chebyshev sweep, the operator and each stage applying
    # stencil_kernel to the padded block; at amg_dims f32, then at
    # small_dims f64 (the JAX package's count)
    t0 = time.perf_counter()
    mstep, (mb,) = dist_md_entry(amg_dims, grid=DIST_MD_GRID, comm=comm,
                                 device=device)
    setup_s = time.perf_counter() - t0
    mg = mstep.grid
    ext = halo_pad(mb, mstep.mdmap, mg)
    mop = StencilOp.create(tuple(reversed(ext.shape)),
                           cross3d_stencil(6.0, *([-1.0] * 6)))
    flat = torch.zeros(mop.n_rows_pad, dtype=mb.dtype, device=device)
    flat[:mop.n_rows] = ext.reshape(-1)
    bitwise("md padded block stencil", stencil_spmv(mop, flat),
            stencil_spmv_plain(mop, flat))
    res = run("md", mstep, mb, via=mg)
    out["md"].update(setup_s=setup_s, x=res.x, coords=mg.coords,
                     block=tuple(mb.shape), padded=tuple(ext.shape))
    md_timing = None
    if me == 0:
        mconv = stencil_conv(mop)
        md_timing = kernel_timing(
            lambda: stencil_spmv(mop, flat),
            lambda: stencil_spmv_plain(mop, flat),
            lambda: mconv(flat[:mop.n_rows]),
            "padded block " + "x".join(map(str, ext.shape)) + " f32 (the md "
            f"CG's operator, rank 0 of a {DIST_MD_GRID} grid)",
            2 * mop.n_rows_pad * 4, 2 * mop.nnz)
    comm.barrier()
    del mstep, mb, ext, flat, res
    mstep_s, (sb,) = dist_md_entry(small_dims, grid=DIST_MD_GRID, comm=comm,
                                  dtype=np.float64, device=device)
    run("md_small", mstep_s, sb, via=mstep_s.grid)
    del mstep_s, sb

    # (c) the column-block dense LU over the ranks: a + n·I, f64, k = 4
    rng = np.random.default_rng(17)
    a_d = rng.standard_normal((DIST_DENSE_N, DIST_DENSE_N))
    a_d[np.diag_indices(DIST_DENSE_N)] += DIST_DENSE_N
    b_d = rng.standard_normal((DIST_DENSE_N, DIST_DENSE_K))
    comm.staged_bytes = 0
    torch.cuda.synchronize()
    comm.barrier()
    t0 = time.perf_counter()
    x_d = dist_dense_solve(comm, a_d, b_d, nb=DIST_DENSE_NB, device=device)
    torch.cuda.synchronize()
    out["dense"] = dict(ms=(time.perf_counter() - t0) * 1e3,
                        staged=comm.staged_bytes)
    if me == 0:
        a_t = torch.from_numpy(a_d).to(device)
        b_t = torch.from_numpy(b_d).to(device)
        t0 = time.perf_counter()
        x_ref = torch.linalg.solve(a_t, b_t)
        torch.cuda.synchronize()
        out["dense"].update(
            res=float(torch.linalg.matrix_norm(a_t @ x_d - b_t)
                      / torch.linalg.matrix_norm(b_t)),
            x_rel=rel_err(x_d, x_ref)[0],
            solve_ms=(time.perf_counter() - t0) * 1e3)
        del a_t, b_t, x_ref
    out["dense"]["x_sum"] = float(x_d.sum())  # the same on every rank
    comm.barrier()
    del a_d, b_d, x_d
    # the dryrun's rank body (entry.dryrun_rank, the twin of the JAX
    # package's dryrun_multichip): every solver and eigensolver kind of the
    # factories over the group (a gate raises on every rank when a kind
    # fails on any), then its tiny distributed solves
    comm.barrier()
    t0 = time.perf_counter()
    dry = dryrun_rank(comm, device)
    torch.cuda.synchronize()

    def values(r):
        v = r[0] if isinstance(r, tuple) else r.eigenvalues
        return np.atleast_1d(v.cpu().numpy() if torch.is_tensor(v)
                             else np.asarray(v))
    out["dryrun"] = dict(
        seconds=time.perf_counter() - t0,
        solvers={k: dict(iters=int(r.iters),
                         converged=bool(torch.as_tensor(r.converged).all()),
                         resnorm=float(torch.as_tensor(r.resnorm).max()))
                 for k, r in dry["solver_kinds"].items()},
        eigen={k: values(r) for k, r in dry["eigen_kinds"].items()},
        steps={k: int(v.iters) for k, v in dry["steps"].items()
               if hasattr(v, "iters")})
    del dry
    out["timing"] = dict(c4=c4_timing, amg=amg_timing, poly=poly_timing,
                         sstep=sstep_timing, eigen=eig_timing, md=md_timing)
    out["backend"] = comm.backend
    return out


def dist_rank_c4_one(comm, device, c4_dims):
    """Config 4 on one rank over the nccl transport (the plumbing on the
    card): its iterations and launches."""
    from trilinos_tpu_torch.entry import dist_pipelined_cg_entry
    from trilinos_tpu_torch.ops import dia_spmv

    step, (b,) = dist_pipelined_cg_entry(c4_dims, n_ranks=1, comm=comm,
                                         device=device)
    dia_spmv.launches = 0
    res = step(b)
    return dict(iters=int(res.iters), converged=bool(res.converged),
                launches=dia_spmv.launches, backend=comm.backend,
                staged=comm.staged_bytes)


def main():
    t_main = time.perf_counter()

    def at(section):
        """Log the seconds since the start as a section begins."""
        log(f"[{time.perf_counter() - t_main:.1f} s] section {section}")

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    if not (pathlib.Path(__file__).resolve().parent
            / "trilinos_tpu_torch").is_dir():
        print("chip_smoke: no trilinos_tpu_torch beside the script; run it "
              "from a checkout of the repository", file=sys.stderr)
        sys.exit(2)

    import importlib

    from trilinos_tpu_torch import native
    from trilinos_tpu_torch.entry import (bdia_cg_entry, block_entry,
                                          bsr_gmres_entry, build_entry,
                                          cheb_entry, elasticity_entry,
                                          entry, factory_entry,
                                          fused_cg_entry, gmres_entry,
                                          komplex_entry,
                                          mm_block_gmres_entry,
                                          pipelined_cg_entry, sstep_entry,
                                          uncoupled_amg_entry, eigen_entry)
    from trilinos_tpu_torch.eigen import (EigenProblem, create_eigensolver,
                                          eigs_near)
    from trilinos_tpu_torch.galeri import (elasticity2d, elasticity3d,
                                           laplace2d, laplace3d, recirc2d,
                                           rigid_body_modes)
    from trilinos_tpu_torch.io import write_sparse
    from trilinos_tpu_torch.ops import komplex
    from trilinos_tpu_torch.precond import (BlockedOperator2x2,
                                            TwoLevelSchwarz,
                                            block_lower_triangular_prec)
    from trilinos_tpu_torch.solvers import (NotSpdError, SparseCholesky,
                                            SparseLu, dense_solve, gmres)
    from trilinos_tpu_torch.galeri.stencils import (cross3d_stencil,
                                                    maxwell2d,
                                                    star2d_stencil)
    from trilinos_tpu_torch.ops import (BdiaMatrix, DiaMatrix, StencilOp,
                                        bdia_planes_plain, bdia_spmm,
                                        bdia_spmv, bdia_spmv_plain,
                                        cg_fused_iteration,
                                        cg_fused_iteration_plain,
                                        chol_inv_small, chol_inv_small_plain,
                                        dia_spmm, dia_spmv, dia_spmv_plain,
                                        stencil_poly_apply,
                                        stencil_poly_plain,
                                        stencil_powers_apply,
                                        stencil_powers_plain, stencil_spmm,
                                        stencil_spmv, stencil_spmv_plain)
    from trilinos_tpu_torch.ops import (_build, choose_format, csr_to_bdia,
                                        csr_to_ell, matvec, pack_planes, smalldense,
                                        spgemm, stencil_op)
    from trilinos_tpu_torch.ops.stencil_poly import (monomial_stages,
                                                     stencil_chebyshev_setup)
    from trilinos_tpu_torch.precond import BlockStructuredAmg, SaAmg
    from trilinos_tpu_torch.precond.structured import ClassifiedStencil
    from trilinos_tpu_torch.solvers.sstep_gmres import newton_basis_stages

    # the package attributes of these names are functions, not modules
    cg_mod = importlib.import_module("trilinos_tpu_torch.solvers.cg")
    sstep_mod = importlib.import_module(
        "trilinos_tpu_torch.solvers.sstep_gmres")
    cheb_mod = importlib.import_module("trilinos_tpu_torch.precond.chebyshev")
    bdia_mod = importlib.import_module("trilinos_tpu_torch.ops.bdia_spmv")
    dia_mod = importlib.import_module("trilinos_tpu_torch.ops.dia_spmv")
    cg_solve = cg_mod.cg
    mm_mod = importlib.import_module("trilinos_tpu_torch.io.matrix_market")
    ilu_mod = importlib.import_module("trilinos_tpu_torch.precond.ilu")

    cg_kernels = {"stencil_spmv": stencil_spmv, "dia_spmv": dia_spmv}
    block_kernels = {"stencil_spmm": stencil_spmm, "dia_spmm": dia_spmm,
                     "chol_inv_small": chol_inv_small}
    cheb_kernels = {"stencil_poly": stencil_poly_apply, **cg_kernels}
    sstep_kernels = {"stencil_powers": stencil_powers_apply,
                     "chol_inv_small": chol_inv_small,
                     "stencil_spmv": stencil_spmv}
    fused_kernels = {"cg_fused": cg_fused_iteration,
                     "stencil_spmv": stencil_spmv}
    el_kernels = {"bdia_spmv": bdia_spmv}
    plane_kernels = {"bdia_spmm": bdia_spmm}
    all_kernels = {**cg_kernels, **block_kernels, **cheb_kernels,
                   **sstep_kernels, **fused_kernels, **el_kernels,
                   **plane_kernels}

    def setup(label, fn):
        """fn() with the SpGEMM path counts set to 0 just before; fails
        unless the native SpGEMM served every product. Returns (result,
        seconds)."""
        spgemm.native_calls = spgemm.numpy_calls = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        log(f"setup {label}: {secs:.2f} s; SpGEMM products: native "
            f"{spgemm.native_calls}, numpy {spgemm.numpy_calls}")
        if spgemm.numpy_calls or not spgemm.native_calls:
            fail(f"setup {label}: the native SpGEMM did not serve it")
        return out, secs

    at("1")
    # -- 1. the card ---------------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    at("2")
    # -- 2. build (one nvcc per source, all started together) ----------------
    t0 = time.perf_counter()
    built = _build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"({', '.join(f'{k} {v:.2f} s' for k, v in built.items())})")
    t0 = time.perf_counter()
    lib = native.build()
    log(f"native host library build (g++: SpGEMM, Matrix Market reader, "
        f"ILU(0), ILUT, ILU(k)): {time.perf_counter() - t0:.2f} s -> {lib}")
    if lib is None:
        fail("no g++: the native host library cannot be built")
    for name in _build.KERNELS:
        report = (_build.BUILD_DIR / f"{name}.log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "Compiling entry" in line or "registers" in line \
                        or "spill" in line:
                    log(f"  ptxas {name}: {line.strip()}")

    at("3")
    # -- 3. stencil kernels against their plain versions ---------------------
    # the single-vector SpMV, bitwise, at the paths' shapes and at every
    # geometry of tests/test_torch_spmv_tile.py, f32 and f64, with pad
    # rows (n_pad rounds n up to 1024); x 4 and 8 bytes past 16-byte
    # alignment (vw 1 and 2); the generic instance on a 2-D 9-point star,
    # a radius-2 stencil, 32 random terms and the cross in another order
    lap = cross3d_stencil(6.0, *([-1.0] * 6))
    wide = lap + [((-2, 0, 0), 0.25), ((0, 2, 0), -0.125), ((0, 0, -2), 0.5),
                  ((2, -1, 1), 0.0625)]
    rng = np.random.default_rng(7)
    span = [(dx, dy, dz) for dz in range(-2, 3) for dy in range(-2, 3)
            for dx in range(-2, 3)]
    rand32 = [(span[i], float(c)) for i, c in zip(
        rng.choice(len(span), 32, replace=False), rng.standard_normal(32))]
    err = dict.fromkeys(all_kernels, 0.0)
    f32, f64 = torch.float32, torch.float64
    spmv_cases = [  # label, dims, stencil, n_pad, dtype, x offset
        (f"{GRID} f32", DIMS, lap, None, f32, 0),
        (f"{GRID} f64", DIMS, lap, None, f64, 0),
        (f"{GRID} f32, x 4 bytes past 16-byte alignment", DIMS, lap, None,
         f32, 1),
        ("100^3 f32", (100, 100, 100), lap, None, f32, 0),
        ("16^3 f32 pad rows (n_pad 5120)", (16, 16, 16), lap, 4096 + 1024,
         f32, 0),
        ("128^3 f64", (128, 128, 128), lap, None, f64, 0),
        ("64x8x20 f32, x 8 bytes past 16-byte alignment", (64, 8, 20), lap,
         None, f32, 2),
        ("64x8x20 f64, x 8 bytes past 16-byte alignment", (64, 8, 20), lap,
         None, f64, 1)]
    spmv_cases += [(f"{'x'.join(map(str, d))} {str(dt)[6:]}", d, lap, None,
                    dt, 0)
                   for d in ((1, 1, 1), (2, 200, 1), (3, 5, 7), (16, 16, 16),
                             (255, 256, 3), (255, 64, 3), (257, 3, 2),
                             (37, 19, 11), (64, 8, 20), (128, 128, 128),
                             (1, 65535, 1), (1, 1, 65535))
                   for dt in (f32, f64)]
    spmv_cases += [(f"{label} {str(dt)[6:]} (generic instance)", d, st, None,
                    dt, 0)
                   for label, d, st in (
                       ("31x13 2-D 9-point star", (31, 13), star2d_stencil(
                           8.0, *([-1.0] * 8))),
                       ("37x19x11 radius 2", (37, 19, 11), wide),
                       ("17x11x9 32 random terms", (17, 11, 9), rand32),
                       ("37x19x11 cross in reverse order", (37, 19, 11),
                        lap[::-1]))
                   for dt in (f32, f64)]
    for i, (label, dims, st, npad, dt, shift) in enumerate(spmv_cases):
        op = StencilOp.create(dims, st, n_rows_pad=npad)
        buf = randn(op.n_rows_pad + shift, dt, seed=10 + i)
        x = buf[shift:]
        y = stencil_spmv(op, x)
        torch.cuda.synchronize()
        plan = stencil_op.spmv_plan(op, x.element_size(),
                                    stencil_op.pointer_align(x, y))
        err["stencil_spmv"] = max(err["stencil_spmv"], check(
            f"stencil {label} (vw {plan.vw}, "
            f"{'cross' if plan.cross else 'generic'} instance, z-chunk "
            f"{plan.zc})", y, stencil_spmv_plain(op, x), 0.0))
        del buf, x, y
    # the launcher refuses a plan whose grid starts blocks past the last
    # plane (csrc/spmv_plan.cuh, as the CPU test builds it)
    op = StencilOp.create((37, 19, 11), lap)
    x = randn(op.n_rows_pad, f32, seed=9)
    plan = stencil_op.spmv_plan(op, 4, stencil_op.pointer_align(x))
    oversize = dataclasses.replace(plan, grid=plan.grid[:2] + (
        plan.grid[2] + 1,))
    try:
        stencil_op._call("stencil_spmv_f32", op, x, torch.empty_like(x),
                         plan=oversize)
    except RuntimeError as exc:
        log(f"check stencil_spmv launcher refuses grid {oversize.grid} for "
            f"37x19x11 (z-chunk {plan.zc}): {exc}")
    else:
        fail(f"stencil_spmv launcher took grid {oversize.grid} for 37x19x11")
    # the stencil SpMM, bitwise, at the block path's shape and at the edges
    # of its launch plan: a grid whose nx, ny are multiples of no block's
    # points (nor of the fused iteration's tile, nor nz of its z-chunk),
    # k = 1, 3, 4, pad rows, f64, an X whose data pointer is not 16-byte
    # aligned (the narrow-load instance), a radius-2 operator
    odd = (37, 19, 11)
    mv_cases = [  # label, dims, stencil, k, dtype, X offset in its buffer
        (f"{GRID} k={NRHS}", DIMS, lap, NRHS, torch.float32, 0),
        (f"{GRID} k=4", DIMS, lap, 4, torch.float32, 0),
        ("128^3 f64 k=16", (128, 128, 128), lap, NRHS, torch.float64, 0),
        (f"128^3 k={NRHS}, X 4 bytes past 16-byte alignment",
         (128, 128, 128), lap, NRHS, torch.float32, 1),
        ("10x10x8 (800 rows in 1024 pad rows) k=16", (10, 10, 8), lap, NRHS,
         torch.float32, 0)]
    mv_cases += [(f"37x19x11 k={k}", odd, lap, k, torch.float32, 0)
                 for k in (1, 3, 4, NRHS)]
    mv_cases += [
        ("37x19x11 k=16, X 4 bytes past 16-byte alignment", odd, lap, NRHS,
         torch.float32, 1),
        ("37x19x11 radius 2 k=16", odd, wide, NRHS, torch.float32, 0),
        ("37x19x11 radius 2 k=3 f64", odd, wide, 3, torch.float64, 0),
        # few, long rows: a block of 256 threads would pass 64 along z
        ("2x200x1 k=4 (block capped at 64 along z)", (2, 200, 1), lap, 4,
         torch.float32, 0)]
    for i, (label, dims, st, k, dt, shift) in enumerate(mv_cases):
        op = StencilOp.create(dims, st)
        buf = randn(op.n_rows_pad * k + shift, dt, seed=40 + i)
        x = buf[shift:].view(op.n_rows_pad, k)
        y = stencil_spmm(op, x)
        torch.cuda.synchronize()
        err["stencil_spmm"] = max(err["stencil_spmm"], check(
            f"stencil SpMM {label} {str(dt)[6:]} (X pointer % 16 = "
            f"{x.data_ptr() % 16})", y, stencil_spmv_plain(op, x), 0.0))
        del buf, x, y

    at("4")
    # -- 4. one hierarchy for both paths; DIA kernels on every level ---------
    fine = laplace3d(*DIMS, dtype=np.float32, fmt="stencil")
    amg, jacobi_setup_s = setup(f"{GRID} hierarchy", lambda: SaAmg(
        fine, {"dtype": np.float32}, device="cuda").compute())
    step, (b, state) = entry(amg=amg)
    log("levels " + " -> ".join(type(lv["a"]).__name__ + str(
            getattr(lv["a"], "offsets", ()).__len__())
            for lv in state["levels"])
        + f" -> dense {tuple(state['coarse_inv'].shape)}")
    levels = [lv["a"] for lv in state["levels"][1:]]
    bf16 = [type(a)(data=a.data.to(torch.bfloat16), offsets=a.offsets,
                    n_rows=a.n_rows, n_cols=a.n_cols, nnz=a.nnz)
            for a in levels]
    # bf16 data, f32 x and sum: both versions multiply the same widened
    # values and add in the same order, so f32's tolerance holds; the SpMM
    # is bitwise its plain version (same diagonal order and rounding)
    for i, (a, ab) in enumerate(zip(levels, bf16), start=1):
        xl = randn(a.n_rows_pad, torch.float32, seed=19 + i)
        err["dia_spmv"] = max(err["dia_spmv"], check(
            f"dia level-{i} {a.n_rows_pad} rows x {len(a.offsets)} diags "
            "f32", dia_spmv(a, xl), dia_spmv_plain(a, xl),
            TOL[torch.float32]))
        xk = randn((a.n_rows_pad, NRHS), torch.float32, seed=50 + i)
        for label, m in (("f32", a), ("bf16 data", ab)):
            err["dia_spmm"] = max(err["dia_spmm"], check(
                f"dia SpMM level-{i} k={NRHS} {label}", dia_spmm(m, xk),
                dia_spmv_plain(m, xk), 0.0))
    # the DIA SpMM at the edges of its plan, bitwise: k = 1, 3, 6 (4-, 4-
    # and 8-byte vectors), 1024 (256 lanes a row), an X 4 bytes past 16-byte
    # alignment (one column a thread), f64 (2 × f64 and one f64)
    lv2, coarsest = levels[1], levels[-1]
    lv2_f64 = dataclasses.replace(lv2, data=lv2.data.double())
    dia_edges = [  # label, matrix, k, dtype, X offset in its buffer
        ("level-2 k=1", lv2, 1, torch.float32, 0),
        ("level-2 k=3", lv2, 3, torch.float32, 0),
        ("level-2 k=6", lv2, 6, torch.float32, 0),
        (f"level-{len(levels)} k=1024", coarsest, 1024, torch.float32, 0),
        (f"level-1 k={NRHS}, X 4 bytes past 16-byte alignment", levels[0],
         NRHS, torch.float32, 1),
        ("level-2 k=16 bf16 data, X 4 bytes past 16-byte alignment",
         bf16[1], NRHS, torch.float32, 1),
        (f"level-2 k={NRHS} f64", lv2_f64, NRHS, torch.float64, 0),
        ("level-2 k=6 f64, X 8 bytes past 16-byte alignment", lv2_f64, 6,
         torch.float64, 1)]
    for i, (label, m, k, dt, shift) in enumerate(dia_edges):
        buf = randn(m.n_rows_pad * k + shift, dt, seed=60 + i)
        xk = buf[shift:].view(m.n_rows_pad, k)
        err["dia_spmm"] = max(err["dia_spmm"], check(
            f"dia SpMM {label} (X pointer % 16 = {xk.data_ptr() % 16})",
            dia_spmm(m, xk), dia_spmv_plain(m, xk), 0.0))
        del buf, xk
    a1, a1_bf16 = levels[0], bf16[0]
    x1 = randn(a1.n_rows_pad, torch.float32, seed=20)
    check("dia level-1 bf16 data", dia_spmv(a1_bf16, x1),
          dia_spmv_plain(a1_bf16, x1), TOL[torch.float32])

    at("5")
    # -- 5. chol_inv_small for every k it takes, f32 and f64 -----------------
    def chol_readings(g, l, linv, lp, linvp):
        """(vs plain, ‖LLᵀ − g‖/‖g‖, max|L⁻¹L − I|), all in g's type."""
        vs = max(rel_err(l, lp)[0], rel_err(linv, linvp)[0])
        llt = float(torch.linalg.norm(l @ l.T - g) / torch.linalg.norm(g))
        inv = float((linv @ l - torch.eye(g.shape[0], device="cuda",
                                          dtype=g.dtype)).abs().max())
        return vs, llt, inv

    def within(readings, tol):
        return all(r <= tol[key] for r, key in zip(
            readings, ("vs_plain", "llt", "inv")))

    for dt in (torch.float32, torch.float64):
        tol = CHOL_TOL[dt]
        worst = (0.0, 0.0, 0.0)
        for k in range(1, smalldense.UNROLL_MAX + 1):
            p = randn((4096, k), dt, seed=200 + k)
            for label, panel in (("random", p), ("scaled", p * torch.logspace(
                    -0.5, 0.5, k, device="cuda", dtype=dt))):
                g = with_floor(panel.T @ panel)
                l, linv = chol_inv_small(g)
                lp, linvp = chol_inv_small_plain(g)
                torch.cuda.synchronize()
                err["chol_inv_small"] = max(err["chol_inv_small"],
                                            rel_err(l, lp)[1],
                                            rel_err(linv, linvp)[1])
                got = chol_readings(g, l, linv, lp, linvp)
                worst = tuple(map(max, worst, got))
                if not within(got, tol):
                    fail(f"chol_inv_small {dt} k={k} {label}: vs plain "
                         f"{got[0]:.2e}, LLt {got[1]:.2e}, inv {got[2]:.2e} "
                         f"(tol {tol})")
                if k in (1, 16, 32):
                    log(f"check chol_inv_small {str(dt)[6:]} k={k} {label}: "
                        f"vs plain {got[0]:.3e}, ‖LLᵀ−g‖/‖g‖ {got[1]:.3e}, "
                        f"max|L⁻¹L−I| {got[2]:.3e} (tol {tol})")
                if dt == torch.float64 and k in (16, 32) and label == "random":
                    # the control: the f32 kernel on g rounded to f32, read
                    # in f64 as the f64 kernel is; the f64 gates must
                    # refuse it
                    l32, linv32 = chol_inv_small(g.float())
                    ctl = chol_readings(g, l32.double(), linv32.double(), lp,
                                        linvp)
                    log(f"control chol_inv_small f32 kernel on f64 g, k={k}: "
                        f"vs plain {ctl[0]:.3e}, ‖LLᵀ−g‖/‖g‖ {ctl[1]:.3e}, "
                        f"max|L⁻¹L−I| {ctl[2]:.3e} (f64 tol {tol})")
                    if within(ctl, tol):
                        fail(f"chol_inv_small f64 gates {tol} pass an f32 "
                             f"computation at k={k}")
        log(f"check chol_inv_small k=1..32 {str(dt)[6:]} (random and scaled "
            f"panels): worst vs plain {worst[0]:.3e}, ‖LLᵀ−g‖/‖g‖ "
            f"{worst[1]:.3e}, max|L⁻¹L−I| {worst[2]:.3e}, all within {tol}")

    at("5b")
    # -- 5b. stencil polynomial and fused CG iteration kernels ---------------
    # the Chebyshev AMG smoother's stages (degree 3, Gershgorin λmax, as
    # SaAmg builds them) and the s-step bases: monomial σ = 12 and Newton
    # with one conjugate pair; every case bitwise
    cheb3 = stencil_chebyshev_setup(fine, 3, lmax=ClassifiedStencil
                                    .from_constant(fine.offsets, fine.coeffs)
                                    .gershgorin())
    cheb8 = stencil_chebyshev_setup(fine, 8, lmax=ClassifiedStencil
                                    .from_constant(fine.offsets, fine.coeffs)
                                    .gershgorin())
    mono1, mono4 = monomial_stages(1, 12.0), monomial_stages(4, 12.0)
    mono8 = monomial_stages(8, 12.0)
    newton4 = tuple((a, bt, g, 0.0) for a, bt, g in newton_basis_stages(
        [11.5, 6.0 + 2.5j, 6.0 - 2.5j, 0.8], 12.0))
    newton8 = tuple((a, bt, g, 0.0) for a, bt, g in newton_basis_stages(
        [11.5, 9.0 + 1.0j, 9.0 - 1.0j, 6.0, 4.0 + 2.0j, 4.0 - 2.0j, 1.5,
         0.4], 12.0))
    poly_cases = [  # label, dims, n_pad, z bounds, dtype, stages, powers
        # (a label naming radius 2 takes the radius-2 stencil)
        (f"{GRID} f32 Chebyshev s=3", DIMS, None, None, torch.float32,
         cheb3, False),
        (f"{GRID} f32 monomial s=4", DIMS, None, None, torch.float32, mono4,
         True),
        (f"{GRID} f32 Newton s=4 (one conjugate pair)", DIMS, None, None,
         torch.float32, newton4, True),
        ("16^3 f32 pad rows (n_pad 5120) Chebyshev", (16, 16, 16), 5120,
         None, torch.float32, cheb3, False),
        ("16^3 f32 pad rows (n_pad 5120) monomial", (16, 16, 16), 5120, None,
         torch.float32, mono4, True),
        ("64^3 f32 z bounds (3, 60) Chebyshev", (64, 64, 64), None, (3, 60),
         torch.float32, cheb3, False),
        ("64^3 f32 z bounds (3, 60) Newton", (64, 64, 64), None, (3, 60),
         torch.float32, newton4, True),
        ("128^3 f64 Chebyshev", (128, 128, 128), None, None, torch.float64,
         cheb3, False),
        ("128^3 f64 monomial", (128, 128, 128), None, None, torch.float64,
         mono4, True),
        ("64^3 f32 monomial s=1", (64, 64, 64), None, None, torch.float32,
         mono1, True),
        ("64^3 f32 Chebyshev s=1", (64, 64, 64), None, None, torch.float32,
         cheb3[:1], False),
        ("64^3 f32 Chebyshev s=8", (64, 64, 64), None, None, torch.float32,
         cheb8, False),
        ("64^3 f32 z bounds (3, 60) Newton s=8", (64, 64, 64), None, (3, 60),
         torch.float32, newton8, True),
        ("37x19x11 radius 2 f32 Chebyshev s=3", odd, None, None,
         torch.float32, cheb3, False),
        ("37x19x11 radius 2 f32 pad rows (n_pad 8192) monomial", odd, 8192,
         None, torch.float32, mono4, True),
        ("10x6x5 f32 (smaller than one tile) Newton", (10, 6, 5), None, None,
         torch.float32, newton4, True),
        ("10x6x5 f64 (smaller than one tile) Chebyshev", (10, 6, 5), None,
         None, torch.float64, cheb3, False),
        ("37x19x11 radius 2 f64 monomial s=8 (split launches)", odd, None,
         (2, 9), torch.float64, mono8, True),
        ("37x19x11 radius 2 f64 Chebyshev s=8 (split launches)", odd, None,
         None, torch.float64, cheb8, False)]
    poly_mod = importlib.import_module("trilinos_tpu_torch.ops.stencil_poly")
    for i, (label, dims, npad, zb, dt, stages, powers) in enumerate(
            poly_cases):
        st = wide if "radius 2" in label else lap
        op = StencilOp.create(dims, st, n_rows_pad=npad)
        plan = poly_mod.stencil_poly_plan(op, tuple(stages),
                                          torch.finfo(dt).bits // 8)
        if ("split" in label) != (len(plan.launches) > 1):
            fail(f"stencil polynomial {label}: {len(plan.launches)} "
                 "launches planned")
        x = randn(op.n_rows_pad, dt, seed=300 + i)
        name, kern, plain = (
            ("stencil_powers", stencil_powers_apply, stencil_powers_plain)
            if powers else
            ("stencil_poly", stencil_poly_apply, stencil_poly_plain))
        y = kern(op, stages, x, z_bounds=zb)
        torch.cuda.synchronize()
        err[name] = max(err[name], check(
            f"{name} {label}", y, plain(op, stages, x, z_bounds=zb), 0.0))
        del x, y
    # the fused polynomial's geometry on the two paths: tile, z-chunk,
    # rings and the redundant halo work the overlapped tiles cost
    for label, stages in (("Chebyshev s=3", cheb3), ("monomial s=4", mono4)):
        plan = poly_mod.stencil_poly_plan(fine, tuple(stages), 4)
        log(f"stencil polynomial plan {GRID} f32 {label}: tile {plan.tile}, "
            f"z-chunk {plan.zc}, grid {plan.grid}, launches "
            f"{[(ln.count, ln.slots, ln.smem) for ln in plan.launches]}, "
            f"xy halo work per output point and stage {plan.redundancy:.3f}")
    # one fused CG iteration from the same state: the five vectors bitwise
    # and scal to the tolerance; then five chained iterations, each side on
    # its own outputs; then a sixth from the plain chain's state on both
    # sides, where β and α_prev are not 0, again bitwise. max_abs_err reads
    # every single-iteration check, scal's absolute error included (scal
    # is held to CG_FUSED_TOL relative), and not the chained ones
    b0 = randn(fine.n_rows_pad, torch.float32, seed=400)
    w0 = stencil_spmv_plain(fine, b0)
    zeros = torch.zeros_like(b0)
    scal0 = torch.stack([b0 @ b0, b0 @ w0, zeros[0], zeros[0] + 1]).reshape(
        1, 4)
    k_state = p_state = (zeros, b0, w0, zeros, zeros, scal0)
    names = ("x", "r", "w", "p", "q", "scal")
    for it in range(5):
        k_state = cg_fused_iteration(fine, *k_state)
        p_state = cg_fused_iteration_plain(fine, *p_state)
        torch.cuda.synchronize()
        step_label = "iteration 1" if it == 0 else f"chained iteration {it + 1}"
        for nm, got, want in zip(names, k_state, p_state):
            e = check(f"cg_fused {GRID} f32 {step_label} {nm}", got, want,
                      CG_FUSED_TOL if nm == "scal" or it else 0.0)
            if it == 0:
                err["cg_fused"] = max(err["cg_fused"], e)
    rz, _, rz_prev, alpha_prev = p_state[5][0].tolist()
    k_state = cg_fused_iteration(fine, *p_state)
    p_state = cg_fused_iteration_plain(fine, *p_state)
    torch.cuda.synchronize()
    for nm, got, want in zip(names, k_state, p_state):
        err["cg_fused"] = max(err["cg_fused"], check(
            f"cg_fused {GRID} f32 iteration 6 from the plain chain's state "
            f"(β {rz / rz_prev:.6g}, α_prev {alpha_prev:.6g}) {nm}", got,
            want, CG_FUSED_TOL if nm == "scal" else 0.0))
    del k_state, p_state, b0, w0, zeros
    # one iteration at the edges of its tile, from a first state (β = 0)
    # and from one with β, α_prev ≠ 0: the odd grid, 128³ f64, radius 2
    for label, dims, st, dt in (
            ("37x19x11 f32", odd, lap, torch.float32),
            ("128^3 f64", (128, 128, 128), lap, torch.float64),
            ("37x19x11 radius 2 f32", odd, wide, torch.float32)):
        op = StencilOp.create(dims, st, n_rows_pad=int(np.prod(dims)))
        r0, p0, q0 = randn((3, op.n_rows), dt, seed=410)
        w0 = stencil_spmv_plain(op, r0)
        first = torch.stack([r0 @ r0, r0 @ w0, r0[0] * 0, r0[0] * 0 + 1])
        later = torch.stack([r0 @ r0, r0 @ w0, r0 @ r0 * 1.25,
                             r0[0] * 0 + 0.5])
        for when, scal, p_, q_ in (("β = 0", first, p0 * 0, q0 * 0),
                                   ("β ≠ 0", later, p0, q0)):
            cg_in = (p0, r0, w0, p_, q_, scal.reshape(1, 4))
            got = cg_fused_iteration(op, *cg_in)
            want = cg_fused_iteration_plain(op, *cg_in)
            torch.cuda.synchronize()
            for nm, g, w_ in zip(names, got, want):
                err["cg_fused"] = max(err["cg_fused"], check(
                    f"cg_fused {label} one iteration, {when}, {nm}", g, w_,
                    CG_FUSED_TOL if nm == "scal" else 0.0))

    at("6")
    # -- 6. the CG path, then the plain versions as reference ----------------
    res, solve_ms, cg_launches, cg_per, cg_gaps = run_marked(
        step, (b, state), SaAmg, "apply_state", cg_kernels)
    iters = int(res.iters)
    log(f"CG path: converged {bool(res.converged)} iters {iters} "
        f"first solve {solve_ms:.1f} ms launches {cg_launches}; launches "
        f"between preconditioner calls {cg_gaps}")
    if not bool(res.converged):
        fail("CG path did not converge")
    for name, count in cg_launches.items():
        if count == 0:
            fail(f"CG path never launched {name}")
    b64 = b.double()
    true_rel = float(torch.linalg.vector_norm(
        b64 - stencil_spmv_plain(fine, res.x.double()))
        / torch.linalg.vector_norm(b64))
    log(f"true relative residual (plain operator, f64): {true_rel:.3e}")
    if not true_rel <= RTOL:
        fail(f"true residual {true_rel:.3e} > {RTOL}")

    plain_patches = (
        (matvec, "stencil_spmv", stencil_spmv_plain),
        (matvec, "dia_spmv", dia_spmv_plain),
        (smalldense, "chol_inv_small", chol_inv_small_plain),
        (cheb_mod, "stencil_poly_apply", stencil_poly_plain),
        (sstep_mod, "stencil_powers_apply", stencil_powers_plain),
        (cg_mod, "cg_fused_iteration", cg_fused_iteration_plain),
        (matvec, "bdia_spmv", bdia_spmv_plain),
        (bdia_mod, "bdia_spmm", lambda a, x, layout="interleaved": (
            bdia_planes_plain if layout == "planes" else bdia_spmv_plain)(
                a, x)))

    def plain_run(fn, *args):
        """fn(*args) with the plain versions patched in for every kernel;
        fails if a kernel launched. Returns (result, wall ms)."""
        before = counts(all_kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            for owner, attr, plain in plain_patches:
                stack.enter_context(mock.patch.object(owner, attr, plain))
            out = fn(*args)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if counts(all_kernels) != before:
            fail("a plain reference run launched a kernel")
        return out, ms

    ref, plain_solve_ms = plain_run(step, b, state)
    rel_x, _ = rel_err(res.x, ref.x)
    log(f"plain reference: converged {bool(ref.converged)} iters "
        f"{int(ref.iters)} solve {plain_solve_ms:.1f} ms; "
        f"max|Δx|/max|x| = {rel_x:.3e}")
    if abs(int(ref.iters) - iters) > 1:
        fail(f"iteration counts {iters} vs {int(ref.iters)}")
    if not rel_x <= TOL[torch.float32]:
        fail(f"kernel and plain solves differ: {rel_x:.3e} > "
             f"{TOL[torch.float32]:.0e}")
    del ref
    # the first solve pays one-time costs (library handles, lazy module
    # loading); the same solve again is the steady-state time
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(b, state)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3

    at("7")
    # -- 7. the block GMRES path, then the plain versions as reference -------
    t0 = time.perf_counter()
    bstep, (bb, bstate) = block_entry(nrhs=NRHS, amg=amg)
    torch.cuda.synchronize()
    log(f"block right-hand sides ({GRID} x {NRHS}): "
        f"{time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    # the DIA SpMM's launches by level (rows) in this solve, recorded at
    # its launcher
    dia_by_rows = collections.Counter()
    dia_launch = dia_mod._launch

    def dia_recorded(kind, a, x):
        if kind == "spmm":
            dia_by_rows[a.n_rows_pad] += 1
        return dia_launch(kind, a, x)

    with mock.patch.object(dia_mod, "_launch", dia_recorded):
        bres, bsolve_ms, b_launches, b_per, b_gaps = run_marked(
            bstep, (bb, bstate), SaAmg, "apply_state", block_kernels)
    bpeak = torch.cuda.max_memory_allocated() / 2**30
    steps = int(bres.iters)
    log(f"block path: converged {bres.converged.tolist()} block steps "
        f"{steps} first solve {bsolve_ms:.1f} ms launches {b_launches}; "
        f"launches between preconditioner calls {b_gaps}; peak memory "
        f"{bpeak:.2f} GiB")
    if not bool(bres.converged.all()):
        fail("block path did not converge in every column")
    for name, count in b_launches.items():
        if count == 0:
            fail(f"block path never launched {name}")
    bb64 = bb.double()
    col_rel = (torch.linalg.vector_norm(
        bb64 - stencil_spmv_plain(fine, bres.x.double()), dim=0)
        / torch.linalg.vector_norm(bb64, dim=0))
    log(f"block true relative residuals (plain operator, f64): worst "
        f"{float(col_rel.max()):.3e}, best {float(col_rel.min()):.3e}")
    if not bool((col_rel <= RTOL).all()):
        fail(f"block true residual {float(col_rel.max()):.3e} > {RTOL}")
    bx = bres.x
    del bres
    torch.cuda.reset_peak_memory_stats()
    bref, bplain_ms = plain_run(bstep, bb, bstate)
    bplain_peak = torch.cuda.max_memory_allocated() / 2**30
    brel_x, _ = rel_err(bx, bref.x)
    log(f"block plain reference: converged {bool(bref.converged.all())} "
        f"block steps {int(bref.iters)} solve {bplain_ms:.1f} ms; "
        f"max|Δx|/max|x| = {brel_x:.3e}; peak memory {bplain_peak:.2f} GiB")
    if abs(int(bref.iters) - steps) > 1:
        fail(f"block steps {steps} vs {int(bref.iters)}")
    if not brel_x <= BLOCK_X_TOL:
        fail(f"kernel and plain block solves differ: {brel_x:.3e} > "
             f"{BLOCK_X_TOL:.0e}")
    del bref, bx
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bstep(bb, bstate)
    torch.cuda.synchronize()
    bwarm_ms = (time.perf_counter() - t0) * 1e3

    def warm(fn, *args):
        """Wall ms of a second, warm run of fn(*args)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def true_residual(x, rhs):
        r64 = rhs.double()
        return float(torch.linalg.vector_norm(
            r64 - stencil_spmv_plain(fine, x.double()))
            / torch.linalg.vector_norm(r64))

    at("7b")
    # -- 7b. AMG-PCG with the Chebyshev smoother: a second hierarchy -------
    camg, cheb_setup_s = setup(f"{GRID} Chebyshev hierarchy", lambda: SaAmg(
        fine, {"dtype": np.float32, "smoother: type": "chebyshev"},
        device="cuda").compute())
    cstep, (cb, cstate) = cheb_entry(amg=camg)
    cres, csolve_ms, c_launches, c_per, c_gaps = run_marked(
        cstep, (cb, cstate), SaAmg, "apply_state", cheb_kernels)
    c_fused = stencil_poly_apply.kernel_launches
    citers = int(cres.iters)
    c_true = true_residual(cres.x, cb)
    log(f"Chebyshev path: converged {bool(cres.converged)} iters {citers} "
        f"first solve {csolve_ms:.1f} ms launches {c_launches}; launches "
        f"between preconditioner calls {c_gaps}; stencil_poly kernel "
        f"launches {c_fused}; true relative residual (plain operator, f64) "
        f"{c_true:.3e}")
    if not bool(cres.converged) or not c_true <= RTOL:
        fail(f"Chebyshev path: converged {bool(cres.converged)}, true "
             f"residual {c_true:.3e}")
    # every polynomial apply is one fused launch
    if c_fused != c_launches["stencil_poly"]:
        fail(f"Chebyshev path: {c_fused} polynomial kernel launches for "
             f"{c_launches['stencil_poly']} applies")
    # the fine level's 4 Jacobi sweeps become 2 polynomial applies (pre and
    # post); the coarse DIA levels smooth as on the Jacobi path
    if c_per != {"stencil_poly": 2, "stencil_spmv": 5,
                 "dia_spmv": cg_per["dia_spmv"]}:
        fail(f"Chebyshev path launches per iteration {c_per}")
    cref, cplain_ms = plain_run(cstep, cb, cstate)
    crel_x, _ = rel_err(cres.x, cref.x)
    log(f"Chebyshev plain reference: converged {bool(cref.converged)} iters "
        f"{int(cref.iters)} solve {cplain_ms:.1f} ms; max|Δx|/max|x| = "
        f"{crel_x:.3e}")
    if abs(int(cref.iters) - citers) > 1 or not crel_x <= TOL[torch.float32]:
        fail(f"Chebyshev kernel and plain solves differ: iters {citers} vs "
             f"{int(cref.iters)}, x {crel_x:.3e}")
    del cref
    cwarm_ms = warm(cstep, cb, cstate)

    at("7c")
    # -- 7c. s-step GMRES with the matrix-powers basis ---------------------
    sstep, (sb,) = sstep_entry(dims=DIMS, device="cuda")
    norms = []
    norm2 = sstep_mod.norm2

    def recorded(*a):
        out = norm2(*a)
        norms.append(float(out))
        return out

    with mock.patch.object(sstep_mod, "norm2", recorded):
        sres, ssolve_ms, s_launches, s_per, s_gaps = run_marked(
            sstep, (sb,), sstep_mod, "cgs2_project_window", sstep_kernels)
        s_fused = stencil_powers_apply.kernel_launches
        k_norms, norms[:] = list(norms), []
        sref, splain_ms = plain_run(sstep, sb)
    s_true = true_residual(sres.x, sb)
    srel_x, _ = rel_err(sres.x, sref.x)
    srel_n = max(abs(a - b) / b for a, b in zip(k_norms, norms))
    log(f"s-step path: iters {sres.iters} (s=4, m=32, 5 cycles) first solve "
        f"{ssolve_ms:.1f} ms launches {s_launches}; launches between block "
        f"projections {s_gaps}; stencil_powers kernel launches "
        f"{s_fused}; residual norms (‖b‖, then β "
        f"and the true ‖r‖ of each cycle) {k_norms}; true relative residual "
        f"(plain operator, f64) {s_true:.3e}")
    log(f"s-step plain reference: iters {sref.iters} solve {splain_ms:.1f} "
        f"ms; norms {norms}; max rel Δ of the norms {srel_n:.3e}, "
        f"max|Δx|/max|x| = {srel_x:.3e}")
    if sres.iters != 160 or sref.iters != 160 or len(k_norms) != len(norms):
        fail(f"s-step runs: iters {sres.iters} vs {sref.iters}")
    if not (srel_n <= SSTEP_TOL and srel_x <= SSTEP_TOL):
        fail(f"s-step kernel and plain runs differ: norms {srel_n:.3e}, x "
             f"{srel_x:.3e} (tol {SSTEP_TOL:.0e})")
    for name, count in s_launches.items():
        if count == 0:
            fail(f"s-step path never launched {name}")
    if s_fused != s_launches["stencil_powers"]:
        fail(f"s-step path: {s_fused} matrix-powers kernel launches for "
             f"{s_launches['stencil_powers']} applies")
    del sref
    swarm_ms = warm(sstep, sb)

    at("7d")
    # -- 7d. fused-iteration CG ---------------------------------------------
    fstep, (fb,) = fused_cg_entry(dims=DIMS, device="cuda")
    fres, fsolve_ms, f_launches, f_per, f_gaps = run_marked(
        fstep, (fb,), cg_mod, "cg_fused_iteration", fused_kernels)
    f_true = true_residual(fres.x, fb)
    log(f"fused CG path: converged {bool(fres.converged)} iters {fres.iters} "
        f"first solve {fsolve_ms:.1f} ms launches {f_launches}; launches "
        f"between iterations {f_gaps}; true relative residual (plain "
        f"operator, f64) {f_true:.3e}")
    if not bool(fres.converged) or not f_true <= RTOL:
        fail(f"fused CG path: converged {bool(fres.converged)}, true "
             f"residual {f_true:.3e}")
    if f_launches["cg_fused"] < fres.iters:
        fail(f"fused CG: {f_launches['cg_fused']} launches for "
             f"{fres.iters} iterations")
    fwarm_ms = warm(fstep, fb)
    f100, _ = fused_cg_entry(dims=DIMS, device="cuda", rtol=0.0,
                             maxiter=FUSED_CG_ITERS)
    k100 = f100(fb)
    p100, f100_plain_ms = plain_run(f100, fb)
    frel_x, _ = rel_err(k100.x, p100.x)
    frel_r = abs(float(k100.resnorm) - float(p100.resnorm)) / float(
        p100.resnorm)
    log(f"fused CG, first {FUSED_CG_ITERS} iterations (rtol 0): kernel "
        f"resnorm {float(k100.resnorm):.6e}, plain {float(p100.resnorm):.6e} "
        f"(rel Δ {frel_r:.3e}); max|Δx|/max|x| = {frel_x:.3e}; plain run "
        f"{f100_plain_ms:.1f} ms")
    if k100.iters != FUSED_CG_ITERS or p100.iters != FUSED_CG_ITERS or not (
            frel_x <= FUSED_CG_X_TOL and frel_r <= FUSED_CG_X_TOL):
        fail(f"fused CG kernel and plain runs differ: x {frel_x:.3e}, "
             f"resnorm {frel_r:.3e} (tol {FUSED_CG_X_TOL:.0e})")
    del k100, p100

    at("7e")
    # -- 7e. the BDIA kernel against its plain version; the elasticity paths -
    # the two sides sum each row in another order: f32 tolerance, not bitwise
    def check_bdia(label, a, x, planes=False):
        name = "bdia_spmm" if planes or x.ndim == 2 else "bdia_spmv"
        got = (bdia_spmm(a, x, layout="planes") if planes
               else bdia_spmv(a, x))
        want = (bdia_planes_plain if planes else bdia_spmv_plain)(a, x)
        torch.cuda.synchronize()
        err[name] = max(err[name], check(f"bdia {label}", got, want,
                                         TOL[x.dtype]))

    def bdia_x(a, k, seed, planes=False, dtype=torch.float32):
        """Seed normals with zero pad rows, interleaved or as planes."""
        x = randn((a.n_rows_pad, k) if k > 1 else a.n_rows_pad, dtype, seed)
        x[a.n_rows:] = 0
        return pack_planes(a, x) if planes else x

    def assemble(label, fn):
        t0 = time.perf_counter()
        out = fn()
        log(f"assemble {label}: {time.perf_counter() - t0:.2f} s, "
            f"{out.shape[0]} dofs, {out.nnz} nonzeros")
        return out

    def no_plain(*args, **kwargs):
        fail("a plain BDIA apply ran on a kernel path")

    def csr_f64(h):
        """The host CSR on the card in f64, for true residuals."""
        return torch.sparse_csr_tensor(
            torch.from_numpy(h.row_ptr), torch.from_numpy(
                h.cols.astype(np.int64)), torch.from_numpy(
                h.vals.astype(np.float64)), h.shape).to("cuda")

    def host_residual(csr, x, rhs):
        n = csr.shape[0]
        r64 = rhs[:n].double()
        return float(torch.linalg.vector_norm(r64 - csr @ x[:n].double())
                     / torch.linalg.vector_norm(r64))

    grid2 = "x".join(map(str, BDIA2D_DIMS))
    a2 = csr_to_bdia(assemble(f"elasticity2d {grid2}", lambda: elasticity2d(
        *BDIA2D_DIMS, e_mod=1.0, dtype=np.float32)), 2, dtype=np.float32,
        device="cuda")
    for k in (1, NRHS):
        check_bdia(f"elasticity2d {grid2} b=2 nd={len(a2.offsets)} planes "
                   f"k={k} f32", a2, bdia_x(a2, k, 500 + k, planes=True),
                   planes=True)
    grid_p = "x".join(map(str, PLANE_DIMS))
    e3 = assemble(f"elasticity3d {grid_p}", lambda: elasticity3d(
        *PLANE_DIMS, e_mod=1.0, dtype=np.float32))
    a3 = csr_to_bdia(e3, 3, dtype=np.float32, device="cuda")
    for k in (1, 4):
        for planes in (False, True):
            check_bdia(f"elasticity3d {grid_p} b=3 nd={len(a3.offsets)} "
                       f"{'planes' if planes else 'interleaved'} k={k} f32",
                       a3, bdia_x(a3, k, 510 + k, planes), planes)
    apad = csr_to_bdia(elasticity3d(10, 10, 9, e_mod=1.0, dtype=np.float32),
                       3, dtype=np.float32, device="cuda")
    if apad.nbr_pad != 904:
        fail(f"pad-row case has {apad.nbr_pad} block rows, not 904")
    for planes in (False, True):
        check_bdia(f"elasticity3d 10x10x9 (900 block rows in 904) "
                   f"{'planes' if planes else 'interleaved'} f32", apad,
                   bdia_x(apad, 1, 520, planes), planes)

    grid_e = "x".join(map(str, EL_DIMS))
    ea = assemble(f"elasticity3d {grid_e}", lambda: elasticity3d(
        *EL_DIMS, e_mod=1.0, dtype=np.float32))
    eamg, el_setup_s = setup(f"elasticity {grid_e} block AMG", lambda:
                             BlockStructuredAmg(
                                 ea, {"dtype": np.float32,
                                      "coarse: max size": 3000},
                                 node_dims=EL_DIMS,
                                 nullspace=rigid_body_modes(*EL_DIMS),
                                 n_equations=3, device="cuda").compute())
    estep, (eb, est) = elasticity_entry(amg=eamg)
    el_levels = [lv["a"] for lv in eamg.levels]
    log("elasticity levels " + " -> ".join(
        f"BDIA b={a.block_size} nd={len(a.offsets)} nbr={a.nbr_pad}"
        for a in el_levels) + f" -> dense {tuple(eamg.coarse_inv.shape)}")
    if sorted({a.block_size for a in el_levels}) != [3, 6]:
        fail("the elasticity hierarchy has no b = 3 and b = 6 levels")
    for i, a in enumerate(el_levels):
        check_bdia(f"elasticity {grid_e} level {i} b={a.block_size} "
                   f"nd={len(a.offsets)} nbr={a.nbr_pad} f32", a,
                   bdia_x(a, 1, 530 + i))
    a0 = el_levels[0]
    a0_bf16 = dataclasses.replace(a0, data=a0.data.to(torch.bfloat16))
    check_bdia(f"elasticity {grid_e} level 0 bf16 data, f32 x", a0_bf16,
               bdia_x(a0, 1, 540))
    a1_f64 = dataclasses.replace(el_levels[1],
                                 data=el_levels[1].data.double())
    check_bdia(f"elasticity {grid_e} level 1 f64", a1_f64,
               bdia_x(a1_f64, 1, 541, dtype=torch.float64))

    ecsr = csr_f64(ea)
    with mock.patch.object(bdia_mod, "bdia_spmv_plain", no_plain):
        eres, esolve_ms, e_launches, e_per, e_gaps = run_marked(
            estep, (eb, est), BlockStructuredAmg, "apply_state", el_kernels)
    eiters = int(eres.iters)
    e_true = host_residual(ecsr, eres.x, eb)
    log(f"elasticity AMG-PCG path: converged {bool(eres.converged)} iters "
        f"{eiters} first solve {esolve_ms:.1f} ms launches {e_launches}; "
        f"launches between preconditioner calls {e_gaps}; true relative "
        f"residual (host CSR, f64) {e_true:.3e}")
    if not bool(eres.converged) or not e_true <= RTOL:
        fail(f"elasticity path: converged {bool(eres.converged)}, true "
             f"residual {e_true:.3e}")
    if e_launches["bdia_spmv"] == 0:
        fail("elasticity path never launched bdia_spmv")
    eref, eplain_ms = plain_run(estep, eb, est)
    erel_x, _ = rel_err(eres.x, eref.x)
    log(f"elasticity plain reference: converged {bool(eref.converged)} iters "
        f"{int(eref.iters)} solve {eplain_ms:.1f} ms; max|Δx|/max|x| = "
        f"{erel_x:.3e}")
    if abs(int(eref.iters) - eiters) > 1 or not erel_x <= BDIA_X_TOL:
        fail(f"elasticity kernel and plain solves differ: iters {eiters} vs "
             f"{int(eref.iters)}, x {erel_x:.3e} (tol {BDIA_X_TOL:.0e})")
    del eref
    ewarm_ms = warm(estep, eb, est)

    at("7f")
    # -- 7f. CG in plane layout on the 64x64x48 elasticity operator ----------
    pstep, (pb,) = bdia_cg_entry(a=a3, iters=PLANE_ITERS)
    zero(plane_kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(bdia_mod, "bdia_planes_plain", no_plain):
        pres = pstep(pb)
    torch.cuda.synchronize()
    psolve_ms = (time.perf_counter() - t0) * 1e3
    p_launches = counts(plane_kernels)
    p3csr = csr_f64(e3)
    p_true = host_residual(p3csr, pres.x, pb)
    log(f"plane-layout CG path: iters {pres.iters} (rtol 0) first solve "
        f"{psolve_ms:.1f} ms launches {p_launches}; recurrence residual "
        f"{float(pres.resnorm):.6e}; true relative residual (host CSR, f64) "
        f"{p_true:.3e}")
    if pres.iters != PLANE_ITERS or p_launches["bdia_spmm"] < PLANE_ITERS:
        fail(f"plane CG: {pres.iters} iterations, launches {p_launches}")
    if not p_true < 1e-2:
        fail(f"plane CG did not reduce the residual: {p_true:.3e}")
    pwarm_ms = warm(pstep, pb)
    pcheck, _ = bdia_cg_entry(a=a3, iters=PLANE_CHECK_ITERS)
    kchk = pcheck(pb)
    rchk, pchk_plain_ms = plain_run(pcheck, pb)
    prel_x, _ = rel_err(kchk.x, rchk.x)
    log(f"plane CG, first {PLANE_CHECK_ITERS} iterations: kernel and plain "
        f"max|Δx|/max|x| = {prel_x:.3e}; plain run {pchk_plain_ms:.1f} ms")
    if not prel_x <= PLANE_X_TOL:
        fail(f"plane CG kernel and plain runs differ: {prel_x:.3e} > "
             f"{PLANE_X_TOL:.0e}")
    del kchk, rchk

    at("7g")
    # -- 7g. GMRES(30) with CGS2, fixed work (rtol 0): f32 and bf16 basis ----
    gmres_mod = importlib.import_module("trilinos_tpu_torch.solvers.gmres")
    gmres_kernels = {"stencil_spmv": stencil_spmv}
    gmres_runs = {}
    for label, bdt, xtol in (("f32 basis", None, TOL[torch.float32]),
                             ("bf16 basis", torch.bfloat16,
                              GMRES_BF16_X_TOL)):
        gstep, gargs = gmres_entry(dims=DIMS, device="cuda", rtol=0.0,
                                   maxiter=GMRES_ITERS, basis_dtype=bdt)
        # the solve's own peak: above what the earlier paths keep allocated
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        gres, gsolve_ms, g_launches, g_per, g_gaps = run_marked(
            gstep, gargs, gmres_mod, "cgs2_project_rows", gmres_kernels)
        gpeak = (torch.cuda.max_memory_allocated() - held) / 2**30
        # one residual before the first cycle and one after each cycle
        want = gres.iters + -(-gres.iters // 30) + 1
        g_true = true_residual(gres.x, gargs[0])
        log(f"GMRES(30) {GRID} f32, {label}, rtol 0: iters {gres.iters} "
            f"first solve {gsolve_ms:.1f} ms launches {g_launches} "
            f"(expected {want}); launches between projections {g_gaps}; "
            f"peak memory above the {held / 2**30:.2f} GiB held before "
            f"{gpeak:.2f} GiB; true relative residual (plain "
            f"operator, f64) {g_true:.3e}")
        if gres.iters != GMRES_ITERS or g_launches["stencil_spmv"] != want:
            fail(f"GMRES {label}: {gres.iters} iterations, launches "
                 f"{g_launches}")
        gref, gplain_ms = plain_run(gstep, *gargs)
        grel_x, _ = rel_err(gres.x, gref.x)
        log(f"GMRES {label} plain reference: iters {gref.iters} solve "
            f"{gplain_ms:.1f} ms; max|Δx|/max|x| = {grel_x:.3e} (tol "
            f"{xtol:.0e})")
        if gref.iters != gres.iters or not grel_x <= xtol:
            fail(f"GMRES {label}: kernel and plain runs differ: iters "
                 f"{gres.iters} vs {gref.iters}, x {grel_x:.3e}")
        del gref, gres
        gmres_runs[label] = dict(
            step=gstep, args=gargs, first=gsolve_ms, plain=gplain_ms,
            warm=warm(gstep, *gargs), peak=gpeak, launches=g_launches,
            per=g_per)

    at("7h")
    # -- 7h. AMG-preconditioned GMRES(30) on the CG path's hierarchy --------
    astep, (ab, ast) = gmres_entry(amg=amg)
    ares, asolve_ms, a_launches, a_per, a_gaps = run_marked(
        astep, (ab, ast), SaAmg, "apply_state", cg_kernels)
    aiters = int(ares.iters)
    a_true = true_residual(ares.x, ab)
    log(f"AMG-GMRES(30) path {GRID} f32, rtol {RTOL}: converged "
        f"{bool(ares.converged)} iters {aiters} first solve {asolve_ms:.1f} ms "
        f"launches {a_launches}; launches between preconditioner calls "
        f"{a_gaps}; true relative residual (plain operator, f64) "
        f"{a_true:.3e}")
    if not bool(ares.converged) or not a_true <= RTOL:
        fail(f"AMG-GMRES: converged {bool(ares.converged)}, true residual "
             f"{a_true:.3e}")
    for name, count in a_launches.items():
        if count == 0:
            fail(f"AMG-GMRES path never launched {name}")
    aref, aplain_ms = plain_run(astep, ab, ast)
    arel_x, _ = rel_err(ares.x, aref.x)
    log(f"AMG-GMRES plain reference: converged {bool(aref.converged)} iters "
        f"{int(aref.iters)} solve {aplain_ms:.1f} ms; max|Δx|/max|x| = "
        f"{arel_x:.3e}")
    if abs(int(aref.iters) - aiters) > 1:
        fail(f"AMG-GMRES iteration counts {aiters} vs {int(aref.iters)}")
    del aref, ares
    awarm_ms = warm(astep, ab, ast)

    at("7i")
    # -- 7i. BASELINE config 2 at its stated size, and the GMRES variants ---
    grid2c = "x".join(map(str, CONFIG2_DIMS))
    t0 = time.perf_counter()
    c2step, (c2b,) = bsr_gmres_entry(dims=CONFIG2_DIMS, device="cuda",
                                     history=True)
    torch.cuda.synchronize()
    c2_setup_s = time.perf_counter() - t0
    c2csr = csr_f64(laplace3d(*CONFIG2_DIMS))
    zero(all_kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    c2res = c2step(c2b)
    torch.cuda.synchronize()
    c2solve_ms = (time.perf_counter() - t0) * 1e3
    c2_launches = {k: v for k, v in counts(all_kernels).items() if v}
    hist = c2res.history.cpu().numpy()
    col_iters = [int(np.flatnonzero(np.isfinite(hist[:, c]))[-1])
                 for c in range(hist.shape[1])]
    c2_true = [host_residual(c2csr, c2res.x[:, c], c2b[:, c])
               for c in range(c2b.shape[1])]
    log(f"BASELINE config 2 (Laplace3D {grid2c} BSR b=4, Relaxation, "
        f"GMRES(30), nrhs {c2b.shape[1]}, f64, rtol 1e-8): set-up "
        f"{c2_setup_s:.2f} s; converged {c2res.converged.tolist()} iters "
        f"per column {col_iters} (max {c2res.iters}); first solve "
        f"{c2solve_ms:.1f} ms; kernel launches {c2_launches or 'none'}; true "
        f"relative residuals (host CSR, f64) "
        f"{[f'{r:.3e}' for r in c2_true]}")
    if not bool(c2res.converged.all()) or max(c2_true) > CONFIG2_RTOL:
        fail(f"config 2: converged {c2res.converged.tolist()}, true "
             f"residuals {c2_true}")
    if max(col_iters) != c2res.iters:
        fail(f"config 2: column iterations {col_iters}, iters {c2res.iters}")
    c2warm_ms = warm(c2step, c2b)
    c2_variants = {}
    col0 = c2b[:, :1].contiguous()
    for solver in ("fgmres", "single_reduce", "pipeline"):
        vstep, _ = bsr_gmres_entry(dims=CONFIG2_DIMS, device="cuda",
                                   solver=solver)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vres = vstep(col0)
        torch.cuda.synchronize()
        vms = (time.perf_counter() - t0) * 1e3
        v_true = host_residual(c2csr, vres.x[:, 0], col0[:, 0])
        log(f"config 2 column 0, {solver}: converged "
            f"{bool(vres.converged.all())} iters {vres.iters} solve "
            f"{vms:.1f} ms; true relative residual (host CSR, f64) "
            f"{v_true:.3e}")
        if not bool(vres.converged.all()) or not v_true <= CONFIG2_RTOL:
            fail(f"config 2 {solver}: converged {vres.converged.tolist()}, "
                 f"true residual {v_true:.3e}")
        c2_variants[solver] = (vres.iters, vms, vstep)

    at("7j")
    # -- 7j. every single-RHS factory kind at 256³, AMG-preconditioned -------
    # create_solver(name, params).solve(LinearProblem(...)) on the CG path's
    # hierarchy (factory_entry); LSQR unpreconditioned at a fixed count
    def drive(step_, args):
        """step_(*args) with every count set to 0 just before and read just
        after. Returns (result, wall ms, the counts that moved)."""
        zero(all_kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step_(*args)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        return out, ms, {k: v for k, v in counts(all_kernels).items() if v}

    kinds = [
        ("CG", {"Estimate Condition Number": 20,
                "Record Residual History": True}),
        ("Pipelined CG", {}), ("Pseudoblock Stochastic CG", {}), ("RCG", {}),
        ("MINRES", {}), ("BiCGStab", {}), ("TFQMR", {}), ("Fixed Point", {}),
        ("GCRODR", {"Num Blocks": 30, "Num Recycled Blocks": 8}),
        ("Hybrid Block GMRES", {"Maximum Degree": 4}),
        ("LSQR", {"Convergence Tolerance": 0.0,
                  "Maximum Iterations": LSQR_ITERS})]
    fk_runs = {}
    for name, params in kinds:
        kstep, kargs = factory_entry(
            name, {"Convergence Tolerance": RTOL, **params}, amg=amg)
        kres, kms, klaunch = drive(kstep, kargs)
        kiters = int(kres.iters)
        k_true = true_residual(kres.x, kargs[0])
        log(f"factory {name!r} {GRID} f32: converged "
            f"{bool(torch.as_tensor(kres.converged).all())} iters {kiters} "
            f"first solve {kms:.1f} ms launches {klaunch}; true relative "
            f"residual (plain operator, f64) {k_true:.3e}")
        if name == "LSQR":
            # rtol 0: a fixed count, gated on its residual and held to the
            # same steps through the plain versions
            lref, lms = plain_run(kstep, *kargs)
            l_rel_x, _ = rel_err(kres.x, lref.x)
            log(f"LSQR plain reference: iters {int(lref.iters)} solve "
                f"{lms:.1f} ms; max|Δx|/max|x| = {l_rel_x:.3e} (tol "
                f"{TOL[torch.float32]:.0e}); true residual gate "
                f"{LSQR_TRUE_MAX:.0e}")
            if (kiters != LSQR_ITERS or int(lref.iters) != LSQR_ITERS
                    or not k_true <= LSQR_TRUE_MAX
                    or not l_rel_x <= TOL[torch.float32]):
                fail(f"LSQR: {kiters} iterations (plain {int(lref.iters)}), "
                     f"true residual {k_true:.3e}, x against plain "
                     f"{l_rel_x:.3e}")
            del lref
        elif not bool(kres.converged) or not k_true <= RTOL:
            fail(f"factory {name!r}: converged {bool(kres.converged)}, true "
                 f"residual {k_true:.3e}")
        need = ["stencil_spmv"] + ([] if name == "LSQR" else ["dia_spmv"])
        need += ["chol_inv_small"] if name == "GCRODR" else []
        for kname in need:
            if not klaunch.get(kname):
                fail(f"factory {name!r} never launched {kname}")
        if name == "CG":
            ce, h = float(kres.condest), kres.history
            hist_ok = (bool(torch.isfinite(h[:kiters + 1]).all())
                       and bool(torch.isnan(h[kiters + 1:]).all()))
            log(f"factory 'CG' condition estimate {ce:.4f} (window 20); "
                f"history finite through iteration {kiters} and NaN after: "
                f"{hist_ok}")
            if not (np.isfinite(ce) and ce >= 1.0 and hist_ok):
                fail(f"CG condest {ce} or history pattern {hist_ok}")
        if name == "GCRODR":
            # the second solve starts from the first one's recycle space
            space = kstep.manager.recycle_space.size
            kres2, kms2, klaunch2 = drive(kstep, kargs)
            k2_true = true_residual(kres2.x, kargs[0])
            log(f"factory 'GCRODR' second solve from a recycle space of "
                f"{space} vectors: converged {bool(kres2.converged)} iters "
                f"{int(kres2.iters)} solve {kms2:.1f} ms launches {klaunch2}; "
                f"true relative residual {k2_true:.3e}")
            if space != 8 or not bool(kres2.converged) or not k2_true <= RTOL:
                fail(f"GCRODR second solve: space {space}, converged "
                     f"{bool(kres2.converged)}, true residual {k2_true:.3e}")
        del kres
        fk_runs[name] = dict(step=kstep, args=kargs, iters=kiters, first=kms,
                             launches=klaunch, warm=warm(kstep, *kargs))

    at("7k")
    # -- 7k. the block kinds at 256³: Block CG (k = 16), Block GCRODR (k = 4)
    spmm_by_k = collections.Counter()  # stencil SpMM launches by k
    dia_by_k = collections.Counter()  # DIA SpMM launches by (rows, k)
    stencil_call = stencil_op._call

    def stencil_k_recorded(fn, op, x, y, *extra, plan):
        if fn.startswith("stencil_spmm"):
            spmm_by_k[x.shape[1]] += 1
        return stencil_call(fn, op, x, y, *extra, plan=plan)

    def dia_k_recorded(kind, a, x):
        if kind == "spmm":
            dia_by_k[(a.n_rows_pad, x.shape[1])] += 1
        return dia_launch(kind, a, x)

    block_runs = {}
    for name, nrhs in (("Block CG", NRHS), ("Block GCRODR", 4)):
        kstep, kargs = factory_entry(name, {"Convergence Tolerance": RTOL},
                                     nrhs=nrhs, amg=amg)
        spmm_by_k.clear()
        dia_by_k.clear()
        with mock.patch.object(stencil_op, "_call", stencil_k_recorded), \
                mock.patch.object(dia_mod, "_launch", dia_k_recorded):
            kres, kms, klaunch = drive(kstep, kargs)
        bk64 = kargs[0].double()
        col_rel = (torch.linalg.vector_norm(
            bk64 - stencil_spmv_plain(fine, kres.x.double()), dim=0)
            / torch.linalg.vector_norm(bk64, dim=0))
        dia_k = {f"{rows} rows k={k}": c for (rows, k), c in dia_by_k.items()}
        log(f"factory {name!r} {GRID} x {nrhs} f32: converged "
            f"{kres.converged.tolist()} iters {int(kres.iters)} first solve "
            f"{kms:.1f} ms launches {klaunch}; stencil SpMM launches by k "
            f"{dict(spmm_by_k)}, DIA SpMM by level and k {dia_k}; true "
            f"relative residuals (plain operator, f64) worst "
            f"{float(col_rel.max()):.3e}")
        if not bool(kres.converged.all()) or not bool((col_rel <= RTOL).all()):
            fail(f"{name}: converged {kres.converged.tolist()}, worst true "
                 f"residual {float(col_rel.max()):.3e}")
        if not spmm_by_k[nrhs] or not any(k == nrhs for _, k in dia_by_k):
            fail(f"{name}: no SpMM at k = {nrhs} ({dict(spmm_by_k)}, {dia_k})")
        if name == "Block GCRODR" and not klaunch.get("chol_inv_small"):
            fail("Block GCRODR never launched chol_inv_small")
        block_runs[name] = dict(step=kstep, args=kargs, iters=int(kres.iters),
                                first=kms, launches=klaunch,
                                spmm_by_k=dict(spmm_by_k),
                                dia_by_k=dict(dia_by_k))
        if name == "Block CG":
            bx_k = kres.x
            del kres
            ref, pms = plain_run(kstep, *kargs)
            rel_x, _ = rel_err(bx_k, ref.x)
            log(f"Block CG plain reference: iters {int(ref.iters)} solve "
                f"{pms:.1f} ms; max|Δx|/max|x| = {rel_x:.3e} (tol "
                f"{BLOCK_X_TOL:.0e})")
            if abs(int(ref.iters) - block_runs[name]["iters"]) > 1 or not (
                    rel_x <= BLOCK_X_TOL):
                fail(f"Block CG kernel and plain solves differ: iters "
                     f"{block_runs[name]['iters']} vs {int(ref.iters)}, x "
                     f"{rel_x:.3e}")
            block_runs[name]["plain"] = pms
            del ref, bx_k
        else:
            del kres
        block_runs[name]["warm"] = warm(kstep, *kargs)

    at("7l")
    # -- 7l. BASELINE config 4 on one card: pipelined CG, 128³ DIA, f64 -----
    grid4 = "x".join(map(str, CONFIG4_DIMS))
    t0 = time.perf_counter()
    c4step, (c4b,) = pipelined_cg_entry(dims=CONFIG4_DIMS, device="cuda")
    torch.cuda.synchronize()
    c4_setup_s = time.perf_counter() - t0
    c4a = c4step.matrix
    # the true residual is taken against a CSR of the host matrix, not the
    # DIA storage the solve ran on
    c4csr = csr_f64(laplace3d(*CONFIG4_DIMS))
    c4res, c4ms, c4launch = drive(c4step, (c4b,))
    c4iters = int(c4res.iters)
    c4_true = host_residual(c4csr, c4res.x, c4b)
    log(f"BASELINE config 4 (Laplace3D {grid4} DIA {len(c4a.offsets)} diags, "
        f"{str(c4b.dtype)[6:]}, pipelined CG, rtol 1e-8): set-up "
        f"{c4_setup_s:.2f} s; converged {bool(c4res.converged)} iters "
        f"{c4iters} (CPU f64 CG: {CONFIG4_CPU_ITERS}) first solve {c4ms:.1f} "
        f"ms launches {c4launch}; true relative residual (host CSR, f64) "
        f"{c4_true:.3e} (gate {CONFIG4_RTOL:.1e})")
    if c4b.dtype != torch.float64 or not c4launch.get("dia_spmv"):
        fail(f"config 4: dtype {c4b.dtype}, launches {c4launch}")
    if not bool(c4res.converged) or not c4_true <= CONFIG4_RTOL:
        fail(f"config 4: converged {bool(c4res.converged)}, true residual "
             f"{c4_true:.3e}")
    c4ref, c4plain_ms = plain_run(c4step, c4b)
    c4rel_x, _ = rel_err(c4res.x, c4ref.x)
    log(f"config 4 plain reference: iters {int(c4ref.iters)} solve "
        f"{c4plain_ms:.1f} ms; max|Δx|/max|x| = {c4rel_x:.3e} (tol "
        f"{CONFIG4_X_TOL:.0e})")
    if abs(int(c4ref.iters) - c4iters) > 1 or not c4rel_x <= CONFIG4_X_TOL:
        fail(f"config 4 kernel and plain solves differ: iters {c4iters} vs "
             f"{int(c4ref.iters)}, x {c4rel_x:.3e}")
    c4x = c4res.x  # the distributed config 4 is held to this solution
    del c4ref, c4res
    c4warm_ms = warm(c4step, c4b)

    at("7m")
    # -- 7m. the Stratimikos path: build() on one stored 256³ DIA matrix -----
    t0 = time.perf_counter()
    a256 = laplace3d(*DIMS, dtype=np.float32)
    csr_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dia256 = choose_format(a256, device="cuda")
    torch.cuda.synchronize()
    dia_s = time.perf_counter() - t0
    log(f"host set-up, Galeri Laplace3D {GRID} f32: CSR {csr_s:.2f} s "
        f"({a256.nnz} nonzeros), CSR -> DIA ({len(dia256.offsets)} "
        f"diagonals) {dia_s:.2f} s")
    t0 = time.perf_counter()
    chstep, (chb,) = build_entry("CG", "CHEBYSHEV", a=a256, dia=dia256,
                                 params={"Convergence Tolerance": RTOL,
                                         "Maximum Iterations": 3000})
    torch.cuda.synchronize()
    ch_setup_s = time.perf_counter() - t0
    cheb = chstep.preconditioner
    chres, chms, chlaunch = drive(chstep, (chb,))
    chiters = int(chres.iters)
    ch_true = true_residual(chres.x, chb)
    log(f"build() CG + CHEBYSHEV (degree {cheb.degree}, power-method λmax "
        f"{cheb.lmax:.6f}, λmin {cheb.lmin:.6f}) on {GRID} DIA f32: set-up "
        f"{ch_setup_s:.2f} s; converged {bool(chres.converged)} iters "
        f"{chiters} first solve {chms:.1f} ms launches {chlaunch}; true "
        f"relative residual (plain operator, f64) {ch_true:.3e}")
    if not bool(chres.converged) or not ch_true <= RTOL or not chlaunch.get(
            "dia_spmv"):
        fail(f"build() CG + CHEBYSHEV: converged {bool(chres.converged)}, "
             f"true residual {ch_true:.3e}, launches {chlaunch}")
    chref, chplain_ms = plain_run(chstep, chb)
    chrel_x, _ = rel_err(chres.x, chref.x)
    log(f"build() CG + CHEBYSHEV plain reference: iters {int(chref.iters)} "
        f"solve {chplain_ms:.1f} ms; max|Δx|/max|x| = {chrel_x:.3e}")
    if abs(int(chref.iters) - chiters) > 1 or not chrel_x <= TOL[
            torch.float32]:
        fail(f"build() CG + CHEBYSHEV kernel and plain solves differ: iters "
             f"{chiters} vs {int(chref.iters)}, x {chrel_x:.3e}")
    del chref, chres
    chwarm_ms = warm(chstep, chb)
    fixed = {"Num Blocks": 30, "Convergence Tolerance": 0.0,
             "Maximum Iterations": POLY_ITERS}
    poly_runs = {}
    for prec in ("GMRESPOLY", "None"):
        t0 = time.perf_counter()
        pstep_, (pb_,) = build_entry("GMRES", prec, a=a256, dia=dia256,
                                     params=fixed)
        torch.cuda.synchronize()
        p_setup_s = time.perf_counter() - t0
        pres_, pms_, plaunch_ = drive(pstep_, (pb_,))
        p_true = true_residual(pres_.x, pb_)
        log(f"build() GMRES(30) + {prec} on {GRID} DIA f32, rtol 0: set-up "
            f"{p_setup_s:.2f} s; iters {pres_.iters} first solve {pms_:.1f} "
            f"ms launches {plaunch_}; true relative residual (plain "
            f"operator, f64) {p_true:.3e}")
        if pres_.iters != POLY_ITERS or not plaunch_.get("dia_spmv"):
            fail(f"build() GMRES + {prec}: {pres_.iters} iterations, "
                 f"launches {plaunch_}")
        poly_runs[prec] = dict(step=pstep_, args=(pb_,), true=p_true,
                               first=pms_, launches=plaunch_,
                               warm=warm(pstep_, pb_))
        del pres_
    if not poly_runs["GMRESPOLY"]["true"] < poly_runs["None"]["true"]:
        fail(f"GMRES + GMRESPOLY true residual "
             f"{poly_runs['GMRESPOLY']['true']:.3e} not below plain GMRES's "
             f"{poly_runs['None']['true']:.3e}")

    at("7n")
    # -- 7n. the stored-matrix path: BASELINE config 3 through Matrix Market
    # (recirc2d written and read back by the native reader, ELL, Ilu0 with 20
    # sweeps on DIA factors, DGKS block GMRES nrhs 2, f64)
    grid3 = f"{CONFIG3_NX}x{CONFIG3_NX}"
    a3h = recirc2d(CONFIG3_NX, CONFIG3_NX)
    mm_mod.read_sparse.native_calls = mm_mod.read_sparse.python_calls = 0
    ilu_mod.ilu0_factor.native_calls = ilu_mod.ilu0_factor.python_calls = 0
    with tempfile.TemporaryDirectory() as tmp:
        # a given file: written here once, then only read by the entry
        mtx = pathlib.Path(tmp) / f"recirc2d_{CONFIG3_NX}.mtx"
        write_sparse(mtx, a3h, comment=f"Galeri recirc2d({CONFIG3_NX}, "
                                       f"{CONFIG3_NX})")
        given = (mtx.read_bytes(), mtx.stat().st_mtime_ns)
        t0 = time.perf_counter()
        c3step, (c3b,) = mm_block_gmres_entry(device="cuda",
                                              matrix_file=mtx)
        torch.cuda.synchronize()
        c3_setup_s = time.perf_counter() - t0
        untouched = ((mtx.read_bytes(), mtx.stat().st_mtime_ns) == given
                     and sorted(p_.name for p_ in pathlib.Path(tmp).iterdir())
                     == [mtx.name])
        mtx_bytes = len(given[0])
    back = c3step.matrix
    same = (back.shape == a3h.shape
            and all(np.array_equal(getattr(back, f), getattr(a3h, f))
                    for f in ("row_ptr", "cols", "vals")))
    reads = (mm_mod.read_sparse.native_calls, mm_mod.read_sparse.python_calls)
    facts = (ilu_mod.ilu0_factor.native_calls,
             ilu_mod.ilu0_factor.python_calls)
    ilu3 = c3step.preconditioner
    log(f"Matrix Market round trip, recirc2d {grid3} ({a3h.nnz} nonzeros, "
        f"{mtx_bytes} bytes): CSR read back bitwise the one written {same}; "
        f"reader native {reads[0]}, Python {reads[1]}; ILU(0) native "
        f"{facts[0]}, Python {facts[1]}; factors L "
        f"{type(ilu3._l).__name__} {len(getattr(ilu3._l, 'offsets', ()))} "
        f"diags, U {type(ilu3._u).__name__} "
        f"{len(getattr(ilu3._u, 'offsets', ()))} diags; set-up from the "
        f"given file (read, ELL, ILU) {c3_setup_s:.2f} s; the file's bytes "
        f"and mtime unchanged, nothing written beside it: {untouched}")
    if not same or reads != (1, 0) or facts != (1, 0) or not untouched:
        fail(f"Matrix Market round trip: bitwise {same}, reader paths "
             f"{reads}, ILU(0) paths {facts}, file untouched {untouched}")
    if not (isinstance(ilu3._l, DiaMatrix) and isinstance(ilu3._u,
                                                          DiaMatrix)):
        fail("config 3: the ILU factors are not DIA")
    c3csr = csr_f64(a3h)

    def c3_true(x):
        return [host_residual(c3csr, x[:, c].contiguous(),
                              c3b[:, c].contiguous()) for c in range(2)]

    c3res, c3ms, c3launch = drive(c3step, (c3b,))
    c3steps = int(c3res.iters)
    c3_res = c3_true(c3res.x)
    c3_off = abs(c3steps - CONFIG3_CPU_STEPS) / CONFIG3_CPU_STEPS
    log(f"BASELINE config 3 (recirc2d {grid3}, ELL, ILU(0) 20 sweeps, DGKS "
        f"block GMRES, nrhs 2, f64, rtol 1e-8): converged "
        f"{c3res.converged.tolist()} block steps {c3steps} (CPU f64: "
        f"{CONFIG3_CPU_STEPS}, {100 * c3_off:.2f}% apart) first solve "
        f"{c3ms:.1f} ms launches {c3launch}; true relative residuals (host "
        f"CSR, f64) {[f'{r:.3e}' for r in c3_res]}")
    if (not bool(c3res.converged.all()) or max(c3_res) > CONFIG3_TRUE_MAX
            or c3_off > CONFIG3_STEPS_TOL):
        fail(f"config 3: converged {c3res.converged.tolist()}, true "
             f"residuals {c3_res}, {c3steps} block steps")
    if not c3launch.get("dia_spmm") or not c3launch.get("chol_inv_small"):
        fail(f"config 3 launches {c3launch}")
    c3ref, c3plain_ms = plain_run(c3step, c3b)
    c3ref_res = c3_true(c3ref.x)
    c3rel_x, _ = rel_err(c3res.x, c3ref.x)
    log(f"config 3 plain reference: converged {c3ref.converged.tolist()} "
        f"block steps {int(c3ref.iters)} solve {c3plain_ms:.1f} ms; true "
        f"relative residuals {[f'{r:.3e}' for r in c3ref_res]}; "
        f"max|Δx|/max|x| = {c3rel_x:.3e}")
    if not bool(c3ref.converged.all()) or max(c3ref_res) > CONFIG3_TRUE_MAX:
        fail(f"config 3 plain run: converged {c3ref.converged.tolist()}, "
             f"true residuals {c3ref_res}")
    del c3ref, c3res
    c3warm_ms = warm(c3step, c3b)

    at("7o")
    # -- 7o. uncoupled SA-AMG PCG on a stored Laplace3D 128³ (fine level DIA,
    # coarse levels and transfers ELL), f32
    gridu = "x".join(map(str, UAMG_DIMS))
    au = assemble(f"Laplace3D {gridu} f32 host CSR", lambda: laplace3d(
        *UAMG_DIMS, dtype=np.float32))
    uamg, u_setup_s = setup(f"uncoupled {gridu}", lambda: SaAmg(
        au, {"dtype": np.float32, "aggregation: type": "uncoupled"},
        device="cuda").compute())

    def describe(a):
        if isinstance(a, DiaMatrix):
            return f"DIA {len(a.offsets)} diags"
        return f"ELL k={a.k}"

    log(f"uncoupled {gridu} levels: " + " -> ".join(
        f"{describe(lv['a'])} {lv['a'].n_rows} rows (P ELL k={lv['p'].k}, "
        f"Pt ELL k={lv['pt'].k})" for lv in uamg.levels)
        + f" -> dense {tuple(uamg.coarse_inv.shape)}; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    if not isinstance(uamg.levels[0]["a"], DiaMatrix):
        fail("uncoupled hierarchy: the fine level is not DIA")
    ustep, (ub, ust) = uncoupled_amg_entry(amg=uamg)
    u_kernels = {"dia_spmv": dia_spmv}
    ures, usolve_ms, u_launches, u_per, u_gaps = run_marked(
        ustep, (ub, ust), SaAmg, "apply_state", u_kernels)
    uiters = int(ures.iters)
    ucsr = csr_f64(au)
    u_true = host_residual(ucsr, ures.x, ub)
    log(f"uncoupled AMG-PCG {gridu} f32: converged {bool(ures.converged)} "
        f"iters {uiters} first solve {usolve_ms:.1f} ms launches "
        f"{u_launches}; launches between preconditioner calls {u_gaps}; "
        f"true relative residual (host CSR, f64) {u_true:.3e}")
    if not bool(ures.converged) or not u_true <= RTOL:
        fail(f"uncoupled AMG-PCG: converged {bool(ures.converged)}, true "
             f"residual {u_true:.3e}")
    if not u_launches["dia_spmv"]:
        fail("uncoupled AMG-PCG never launched dia_spmv")
    uref, uplain_ms = plain_run(ustep, ub, ust)
    urel_x, _ = rel_err(ures.x, uref.x)
    log(f"uncoupled plain reference: converged {bool(uref.converged)} iters "
        f"{int(uref.iters)} solve {uplain_ms:.1f} ms; max|Δx|/max|x| = "
        f"{urel_x:.3e} (tol {UAMG_X_TOL:.0e})")
    if abs(int(uref.iters) - uiters) > 1 or not urel_x <= UAMG_X_TOL:
        fail(f"uncoupled kernel and plain solves differ: iters {uiters} vs "
             f"{int(uref.iters)}, x {urel_x:.3e}")
    del uref, ures
    uwarm_ms = warm(ustep, ub, ust)

    at("7p")
    # -- 7p. null-space uncoupled SA-AMG on the elasticity matrix ----------
    nsamg, ns_setup_s = setup(f"null-space uncoupled {grid_e}", lambda: SaAmg(
        ea, {"dtype": np.float32, "nullspace: vectors": rigid_body_modes(
            *EL_DIMS), "number of equations": 3, "smoother: sweeps": 3,
             "smoother: damping factor": 0.6}, device="cuda").compute())
    nsop = nsamg.fine_op
    log(f"null-space uncoupled {grid_e} levels: " + " -> ".join(
        f"{describe(lv['a'])} {lv['a'].n_rows} rows (P ELL k={lv['p'].k}, "
        f"Pt ELL k={lv['pt'].k})" for lv in nsamg.levels)
        + f" -> dense {tuple(nsamg.coarse_inv.shape)}")

    def ns_step(b_vec, st):
        return cg_solve(lambda v: matvec.spmv(nsop, v), b_vec,
                        prec=lambda v: nsamg.apply_state(st, v), rtol=RTOL,
                        maxiter=NS_MAXITER)

    nsst = nsamg.state()
    nsres, nsms, ns_launches, ns_per, ns_gaps = run_marked(
        ns_step, (eb, nsst), SaAmg, "apply_state", u_kernels)
    ns_true = host_residual(ecsr, nsres.x, eb)
    log(f"null-space uncoupled SA-AMG PCG {grid_e} f32 (rigid-body modes, 3 "
        f"Jacobi sweeps at 0.6): converged {bool(nsres.converged)} iters "
        f"{int(nsres.iters)} (BlockStructuredAmg: {eiters}) first solve "
        f"{nsms:.1f} ms launches {ns_launches}; true relative residual "
        f"(host CSR, f64) {ns_true:.3e}")
    if not bool(nsres.converged) or not ns_true <= RTOL:
        fail(f"null-space uncoupled AMG-PCG: converged "
             f"{bool(nsres.converged)}, true residual {ns_true:.3e}")
    nswarm_ms = warm(ns_step, eb, nsst)
    nsiters = int(nsres.iters)
    del nsres

    at("7q")
    # -- 7q. every preconditioner name this slice ports through build() ----
    nxm, nym = MAXWELL_DIMS
    n_edges = nxm * (nym + 1) + (nxm + 1) * nym
    am, gm = maxwell2d(nxm, nym, sigma=10.0 ** np.random.default_rng(
        9).uniform(-3, 0, n_edges))
    ell_m = csr_to_ell(am, device="cuda")
    csr_m = csr_f64(am)
    gmres30 = {"Num Blocks": 30, "Convergence Tolerance": BUILD_RTOL,
               "Maximum Iterations": 1000}
    build_runs = {}
    for label, name, pparams, cpu_iters in BUILD_CASES:
        hip = name == "HIPTMAIR"
        host, op_, csr_ = (am, ell_m, csr_m) if hip else (a3h, c3step.operator,
                                                         c3csr)
        t0 = time.perf_counter()
        bstep_, (bb_,) = build_entry(
            "GMRES", name, a=host, dia=op_, params=gmres30,
            prec_params=pparams, device="cuda",
            **({"aux_op": gm} if hip else {}))
        torch.cuda.synchronize()
        bset_s = time.perf_counter() - t0
        bres_, bms_, blaunch_ = drive(bstep_, (bb_,))
        b_true = host_residual(csr_, bres_.x, bb_)
        conv = bool(torch.as_tensor(bres_.converged).all())
        log(f"build() GMRES(30) + {label} on "
            f"{'maxwell2d ' + 'x'.join(map(str, MAXWELL_DIMS)) if hip else 'recirc2d ' + grid3} "
            f"f64: set-up {bset_s:.2f} s; converged {conv} iters "
            f"{int(bres_.iters)} (JAX package, CPU f64: {cpu_iters}) first "
            f"solve {bms_:.1f} ms launches {blaunch_ or 'none'}; true "
            f"relative residual (host CSR, f64) {b_true:.3e}")
        if not conv or not b_true <= 10 * BUILD_RTOL:
            fail(f"build() GMRES + {label}: converged {conv}, true residual "
                 f"{b_true:.3e}")
        # a preconditioner holding a DIA operator must have run the kernel,
        # as the SpMV or (block relaxation's (n, 1) residuals) the SpMM
        # (Schwarz applies dense inverses; a factor with fill on many
        # diagonals packs as ELL, plain torch)
        holds_dia = any(isinstance(v, DiaMatrix)
                        for v in vars(bstep_.preconditioner).values())
        if holds_dia and not (blaunch_.get("dia_spmv")
                              or blaunch_.get("dia_spmm")):
            fail(f"build() GMRES + {label} never launched the DIA kernel")
        build_runs[label] = dict(iters=int(bres_.iters), cpu=cpu_iters,
                                 first=bms_, setup=bset_s, launches=blaunch_)
        del bres_, bstep_

    at("7q")
    # -- 7q. the direct solvers on the host at real size: native sparse LU on
    # config 3's matrix, native sparse Cholesky on laplace2d 256²
    al2 = laplace2d(CHOL_NX, CHOL_NX)
    direct_host = {}
    for label, cls, host, hname in (
            ("SparseLu", SparseLu, a3h, f"recirc2d {grid3}"),
            ("SparseCholesky", SparseCholesky, al2,
             f"laplace2d {CHOL_NX}x{CHOL_NX}")):
        cls.native_calls = cls.python_calls = 0
        t0 = time.perf_counter()
        fac = cls(host).factor()
        f_s = time.perf_counter() - t0
        paths = (cls.native_calls, cls.python_calls)
        bh = np.random.default_rng(60).standard_normal(
            (host.shape[0], DIRECT_HOST_RHS))
        t0 = time.perf_counter()
        xh = fac.solve(bh)
        s_s = time.perf_counter() - t0
        csr_h = csr_f64(host)
        res_h = [host_residual(csr_h, torch.from_numpy(xh[:, c]).to("cuda"),
                               torch.from_numpy(bh[:, c]).to("cuda"))
                 for c in range(DIRECT_HOST_RHS)]
        log(f"{label} on {hname} ({host.shape[0]} rows, f64): factor "
            f"{f_s:.3f} s, nnz_factors {fac.nnz_factors}, path native "
            f"{paths[0]}, Python {paths[1]}; {DIRECT_HOST_RHS} solves "
            f"{s_s:.3f} s; true relative residuals "
            f"{[f'{r:.3e}' for r in res_h]}")
        if paths != (1, 0):
            fail(f"{label}: the native factorization did not serve {paths}")
        if not max(res_h) <= DIRECT_HOST_TRUE_MAX:
            fail(f"{label}: true residuals {res_h}")
        direct_host[label] = dict(factor_s=f_s, solve_s=s_s,
                                  nnz=fac.nnz_factors, matrix=hname)
        del fac, csr_h
    try:
        SparseCholesky(a3h).factor()
    except NotSpdError as exc:
        log(f"SparseCholesky on recirc2d {grid3} refused: {exc}")
    else:
        fail("SparseCholesky factored the nonsymmetric recirc2d")

    at("7r")
    # -- 7r. the Amesos2 names through build(): DIRECT, AMESOS2, KLU2 with
    # GMRES(30) on recirc2d 64², TACHO and CHOLMOD with CG on laplace2d 64²;
    # the apply is a dense n² inverse on the card
    d_hosts = {"recirc2d": recirc2d(DIRECT_NX, DIRECT_NX),
               "laplace2d": laplace2d(DIRECT_NX, DIRECT_NX)}
    d_ops = {k: choose_format(v, device="cuda") for k, v in d_hosts.items()}
    d_csr = {k: csr_f64(v) for k, v in d_hosts.items()}
    direct_runs = {}
    for name, solver, matrix, cpu_iters in DIRECT_CASES:
        sp = {"Convergence Tolerance": BUILD_RTOL, "Maximum Iterations": 1000}
        if solver == "GMRES":
            sp["Num Blocks"] = 30
        for cls in (SparseLu, SparseCholesky):
            cls.native_calls = cls.python_calls = 0
        t0 = time.perf_counter()
        dstep, (db,) = build_entry(solver, name, a=d_hosts[matrix],
                                   dia=d_ops[matrix], params=sp,
                                   device="cuda")
        torch.cuda.synchronize()
        dset_s = time.perf_counter() - t0
        dpaths = (SparseLu.native_calls + SparseCholesky.native_calls,
                  SparseLu.python_calls + SparseCholesky.python_calls)
        dres, dms, dlaunch = drive(dstep, (db,))
        d_true = host_residual(d_csr[matrix], dres.x, db)
        conv = bool(torch.as_tensor(dres.converged).all())
        inv = dstep.preconditioner.inv_dense
        xg = randn(inv.shape[0], torch.float64, seed=70)
        gemv_ms = graph_ms(lambda: inv @ xg)
        gemv_bound = inv.numel() * inv.element_size() / HBM_BYTES_PER_MS
        log(f"build() {solver} + {name} on {matrix} {DIRECT_NX}x{DIRECT_NX} "
            f"f64: set-up (factor, {inv.shape[0]} host solves, upload) "
            f"{dset_s:.2f} s, factorization native {dpaths[0]}, Python "
            f"{dpaths[1]}; converged {conv} iters {int(dres.iters)} (JAX "
            f"package, CPU f64: {cpu_iters}) first solve {dms:.1f} ms "
            f"launches {dlaunch or 'none'}; true relative residual "
            f"{d_true:.3e}; inverse GEMV {gemv_ms:.4f} ms (bound "
            f"{gemv_bound:.4f} ms, {inv.shape[0]}² x 8 bytes at 3.35 TB/s)")
        if dpaths != (1, 0):
            fail(f"build() + {name}: the native factorization did not serve "
                 f"{dpaths}")
        if not conv or not d_true <= DIRECT_TRUE_MAX \
                or int(dres.iters) != cpu_iters:
            fail(f"build() {solver} + {name}: converged {conv}, true residual "
                 f"{d_true:.3e}, {int(dres.iters)} iterations (CPU "
                 f"{cpu_iters})")
        direct_runs[name] = dict(setup=dset_s, iters=int(dres.iters),
                                 first=dms, gemv=gemv_ms, bound=gemv_bound)
        del dstep, dres, inv
    del d_csr

    at("7s")
    # -- 7s. two-level Schwarz CG on laplace2d 256² ("add" combine, 8 x 8 box
    # subdomains, RGDSW, hybrid coupling: its A·x runs the DIA kernel) beside
    # one-level Schwarz on the same partition (its first level)
    grid_tl = f"{CHOL_NX}x{CHOL_NX}"
    t0 = time.perf_counter()
    tlm = TwoLevelSchwarz(al2, {
        "schwarz: num subdomains": TL_BOXES ** 2,
        "schwarz: subdomain ids": box_ids(CHOL_NX, TL_BOXES),
        "schwarz: combine mode": "add"}, device="cuda").compute()
    torch.cuda.synchronize()
    tl_setup_s = time.perf_counter() - t0
    tl_op = choose_format(al2, device="cuda")
    tl_host = np.zeros(tl_op.n_rows_pad)
    tl_host[:al2.shape[0]] = np.random.default_rng(0).standard_normal(
        al2.shape[0])
    tlb = torch.from_numpy(tl_host).to("cuda")
    tl_csr = csr_f64(al2)

    def tl_step(m):
        def run(b_vec):
            return cg_solve(lambda v: matvec.spmv(tl_op, v), b_vec, prec=m,
                            rtol=TL_RTOL, maxiter=2000)
        return run

    tl_runs = {}
    for label, m in (("two-level", tlm), ("one-level", tlm.level1)):
        res_, ms_, launch_ = drive(tl_step(m), (tlb,))
        true_ = host_residual(tl_csr, res_.x, tlb)
        tl_runs[label] = dict(iters=int(res_.iters), first=ms_,
                              launches=launch_, true=true_,
                              conv=bool(res_.converged))
        del res_
    log(f"CG on laplace2d {grid_tl} f64 with Schwarz ({TL_BOXES ** 2} boxes of "
        f"{CHOL_NX // TL_BOXES}², overlap 1, add): two-level (RGDSW, hybrid, "
        f"set-up {tl_setup_s:.2f} s, Φ {tuple(tlm.phi.shape)}, A stored as "
        f"{type(tlm.a_dev).__name__}) {tl_runs['two-level']['iters']} "
        f"iterations, one-level {tl_runs['one-level']['iters']} (JAX package, "
        f"CPU f64: {TL_CPU_ITERS[0]}, {TL_CPU_ITERS[1]}); first solves "
        f"{tl_runs['two-level']['first']:.1f} ms, "
        f"{tl_runs['one-level']['first']:.1f} ms; true relative residuals "
        f"{tl_runs['two-level']['true']:.3e}, "
        f"{tl_runs['one-level']['true']:.3e}; launches "
        f"{tl_runs['two-level']['launches']}")
    if not all(r["conv"] and r["true"] <= 10 * TL_RTOL
               for r in tl_runs.values()):
        fail(f"two-level Schwarz CG: {tl_runs}")
    if not tl_runs["two-level"]["iters"] < tl_runs["one-level"]["iters"]:
        fail("two-level Schwarz took no fewer iterations than one-level")
    if not tl_runs["two-level"]["launches"].get("dia_spmv"):
        fail("the two-level hybrid's A·x never launched dia_spmv")
    tlwarm_ms = warm(tl_step(tlm), tlb)
    del tl_csr

    at("7t")
    # -- 7t. Komplex: the complex shifted Laplacian through a complex Matrix
    # Market file, solved as its real form with GMRES(30) + RILUK
    grid_k = f"{KOMPLEX_NX}x{KOMPLEX_NX}"
    mm_mod.read_sparse.native_calls = mm_mod.read_sparse.python_calls = 0
    t0 = time.perf_counter()
    kstep, (kbz,) = komplex_entry(KOMPLEX_NX, KOMPLEX_SHIFT, device="cuda")
    k_read_s = time.perf_counter() - t0
    kreads = (mm_mod.read_sparse.native_calls,
              mm_mod.read_sparse.python_calls)
    kerf = komplex.complex_matrix_to_real(kstep.matrix)
    kop = choose_format(kerf, device="cuda")
    (kz, kres), kms, klaunch = drive(kstep, (kbz,))
    ka = kstep.matrix
    kr = np.zeros(ka.shape[0], complex)
    np.add.at(kr, ka._rows(), ka.vals * kz[ka.cols])
    k_true = float(np.linalg.norm(kbz - kr) / np.linalg.norm(kbz))
    kconv = bool(kres.converged)
    log(f"Komplex: laplace2d {grid_k} + {KOMPLEX_SHIFT}i·I ({ka.nnz} complex "
        f"entries) written and read back as a complex Matrix Market file "
        f"({k_read_s:.2f} s; reader native {kreads[0]}, Python {kreads[1]}); "
        f"real form {kerf.shape[0]} rows, {kerf.nnz} entries, stored as "
        f"{type(kop).__name__}"
        + (f" ({len(kop.offsets)} diagonals, offsets ±{ka.shape[0]} hold the "
           f"shift)" if isinstance(kop, DiaMatrix) else "")
        + f"; GMRES(30) + RILUK (set-up included): converged {kconv} iters "
        f"{int(kres.iters)} (JAX package, CPU f64: {KOMPLEX_CPU_ITERS}) "
        f"first solve {kms:.1f} ms launches {klaunch or 'none'}; complex "
        f"true relative residual {k_true:.3e}")
    if not kconv or int(kres.iters) != KOMPLEX_CPU_ITERS \
            or not k_true <= KOMPLEX_TRUE_MAX or kreads != (0, 1):
        fail(f"Komplex: converged {kconv}, {int(kres.iters)} iterations, "
             f"true residual {k_true:.3e}, reader paths {kreads}")
    if isinstance(kop, DiaMatrix) and not klaunch.get("dia_spmv"):
        fail("Komplex: the DIA real form never launched dia_spmv")
    kwarm_ms = warm(kstep, kbz)
    kres_iters = int(kres.iters)
    del kres

    at("7u")
    # -- 7u. Pliris on one card: dense_solve of a diagonally dominant f64
    # system
    ad = randn((DENSE_N, DENSE_N), torch.float64, seed=71)
    ad += DENSE_N * torch.eye(DENSE_N, device="cuda", dtype=torch.float64)
    bd = randn(DENSE_N, torch.float64, seed=72)
    xd = dense_solve(ad, bd)
    dense_ms = warm(dense_solve, ad, bd)
    d_res = float(torch.linalg.vector_norm(bd - ad @ xd)
                  / torch.linalg.vector_norm(bd))
    log(f"dense_solve {DENSE_N}² f64 (torch.linalg.solve): {dense_ms:.2f} ms "
        f"warm; true relative residual {d_res:.3e}")
    if not d_res <= DENSE_TRUE_MAX:
        fail(f"dense_solve: true residual {d_res:.3e}")
    del ad, bd, xd

    at("7v")
    # -- 7v. Teko: GMRES(40) on the blocked 48 + 32 system with block
    # Gauss-Seidel (exact diagonal-block inverses) on the card; the count
    # may move by one, GMRES summing in another order there
    blocks, tdense, tb_host = teko_system()
    t00, t01, t10, t11 = (torch.from_numpy(m_).to("cuda") for m_ in blocks)
    i00, i11 = torch.linalg.inv(t00), torch.linalg.inv(t11)
    n0 = t00.shape[0]
    tblk = BlockedOperator2x2(lambda v: t00 @ v, lambda v: t01 @ v,
                              lambda v: t10 @ v, lambda v: t11 @ v, n0)
    tprec = block_lower_triangular_prec(lambda v: i00 @ v, tblk.a10,
                                        lambda v: i11 @ v, n0)
    tb = torch.from_numpy(tb_host).to("cuda")
    tres = gmres(tblk, tb, prec=tprec, restart=40, rtol=1e-10, maxiter=400)
    t_true = float(np.linalg.norm(tb_host - tdense @ tres.x.cpu().numpy())
                   / np.linalg.norm(tb_host))
    log(f"Teko blocked GMRES(40) + block Gauss-Seidel (48 + 32, f64): "
        f"converged {bool(tres.converged)} iters {int(tres.iters)} (JAX "
        f"package, CPU f64: {TEKO_CPU_ITERS}); true relative residual "
        f"{t_true:.3e}")
    if not bool(tres.converged) or not t_true <= 1e-9 \
            or abs(int(tres.iters) - TEKO_CPU_ITERS) > 1:
        fail(f"Teko: converged {bool(tres.converged)}, {int(tres.iters)} "
             f"iterations, true residual {t_true:.3e}")

    at("7w")
    # -- 7w. the Anasazi eigensolvers: one f64 Jacobi hierarchy of the 256³
    # stencil serves the preconditioned phases (e1 LOBPCG, e2 Block
    # Davidson, e5 LOBPCG on the Q1 mass pencil); each phase is driven
    # through eigen_entry or the factory with the counts at 0 just before,
    # then again through the plain versions
    t_eig = time.perf_counter()
    fine64 = laplace3d(*DIMS, dtype=np.float64, fmt="stencil")
    amg64, eig_setup_s = setup(f"{GRID} f64 hierarchy (eigensolvers)",
                               lambda: SaAmg(fine64, {"dtype": np.float64},
                                             device="cuda").compute())
    levels64 = [lv["a"] for lv in amg64.state()["levels"][1:]]
    mass64 = StencilOp.create(DIMS, mass27_stencil(), dtype="float64")
    # the new kernel shapes against their plain versions: the stencil SpMM
    # at k = 4 and k = 2 in f64 (LOBPCG, Block Davidson and the V-cycle's
    # fine level; Block Krylov-Schur) and on the 27-point mass, the DIA
    # SpMM at k = 4 in f64 on every coarse level, all bitwise;
    # chol_inv_small at k = 4 and at Block Davidson's widest whitening
    # (k = 24), f64
    n64 = fine64.n_rows_pad
    xe4 = randn((n64, EIG_NEV), torch.float64, seed=90)
    xe2 = randn((n64, 2), torch.float64, seed=91)
    eig_err = {
        "spmm4": check(f"stencil SpMM {GRID} k=4 f64", stencil_spmm(
            fine64, xe4), stencil_spmv_plain(fine64, xe4), 0.0),
        "spmm2": check(f"stencil SpMM {GRID} k=2 f64", stencil_spmm(
            fine64, xe2), stencil_spmv_plain(fine64, xe2), 0.0),
        "mass": check(f"stencil SpMM {GRID} 27-point Q1 mass k=4 f64",
                      stencil_spmm(mass64, xe4),
                      stencil_spmv_plain(mass64, xe4), 0.0),
        "dia4": 0.0}
    for i, a in enumerate(levels64, start=1):
        xl = randn((a.n_rows_pad, EIG_NEV), torch.float64, seed=92 + i)
        eig_err["dia4"] = max(eig_err["dia4"], check(
            f"dia SpMM f64 level-{i} {a.n_rows_pad} rows x "
            f"{len(a.offsets)} diags k=4", dia_spmm(a, xl),
            dia_spmv_plain(a, xl), 0.0))
        del xl
    g_eig = {}
    for k in (EIG_NEV, 24):
        pk = randn((4096, k), torch.float64, seed=95 + k)
        g_eig[k] = with_floor(pk.T @ pk)
        eig_err[f"chol{k}"] = check(
            f"chol_inv_small k={k} f64 (eigensolvers)",
            chol_inv_small(g_eig[k])[1], chol_inv_small_plain(g_eig[k])[1],
            CHOL_TOL[torch.float64]["vs_plain"])

    def eig_iters(res):
        """Iterations of any kind's result (None for LANCZOS's fixed
        length and eigs_near)."""
        if isinstance(res, tuple):
            return int(res[2]) if len(res) == 3 else None
        return int(res.iters)

    def eig_vals(res):
        """Eigenvalues of any kind's result as a host array."""
        lam = res[0] if isinstance(res, tuple) else res.eigenvalues
        if isinstance(lam, torch.Tensor):
            lam = lam.detach().cpu().numpy()
        return np.atleast_1d(np.asarray(lam))

    def eig_vecs(res):
        v = res[1] if isinstance(res, tuple) else res.eigenvectors
        return v if v.ndim == 2 else v[:, None]

    def subspace_sin(x, y):
        """sin of the largest principal angle between span(x) and span(y),
        ‖P_x − P_y‖₂ = ‖(I − Q_x Q_xᴴ) Q_y‖₂, on the device (from the
        small Gram of the remainder, accurate to rounding)."""
        dt = torch.complex128 if (x.is_complex() or y.is_complex()) \
            else torch.float64
        qx, qy = torch.linalg.qr(x.to(dt))[0], torch.linalg.qr(y.to(dt))[0]
        r = qy - qx @ (qx.conj().T @ qy)
        return float(torch.sqrt(torch.linalg.eigvalsh(r.conj().T @ r).max()
                                .clamp(min=0)))

    eig_runs = {}

    def eig_run(key, label, step_, args, need=()):
        """step_(*args) through the kernels (counts at 0 just before, peak
        device memory), through the plain versions, and warm; fails unless
        every kernel in ``need`` launched or if the plain run's eigenvalues
        differ by more than EIG_PLAIN_RTOL. Returns the run's record."""
        torch.cuda.reset_peak_memory_stats()
        res, ms, launch = drive(step_, args)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ref, pms = plain_run(step_, *args)
        run = dict(step=step_, args=args, res=res, first=ms, plain=pms,
                   launches=launch, peak=peak, iters=eig_iters(res),
                   ref_iters=eig_iters(ref), vals=eig_vals(res),
                   ref_vals=eig_vals(ref),
                   sin=subspace_sin(eig_vecs(res), eig_vecs(ref)),
                   warm=warm(step_, *args))
        vrel = float(np.max(np.abs(run["vals"] - run["ref_vals"])
                            / np.abs(run["ref_vals"])))
        log(f"{label}: iterations {run['iters']} (plain {run['ref_iters']}) "
            f"eigenvalues {run['vals']!r}; against the plain run "
            f"max|Δλ|/|λ| {vrel:.3e}, subspace sin {run['sin']:.3e}; first "
            f"solve {ms:.1f} ms, warm {run['warm']:.1f} ms, plain "
            f"{pms:.1f} ms; peak device memory {peak:.2f} GiB; launches "
            f"{launch}")
        if not vrel <= EIG_PLAIN_RTOL:
            fail(f"{label}: kernel and plain eigenvalues differ by {vrel:.3e}")
        for kname in need:
            if not launch.get(kname):
                fail(f"{label} never launched {kname}")
        run["label"] = label
        eig_runs[key] = run
        del ref
        return run

    def gate_closed(label, vals, want, rtol=EIG_CLOSED_RTOL):
        rel = np.abs(np.sort(np.real(vals)) - np.sort(want)) / np.abs(want)
        log(f"{label} against the closed form {np.sort(want)!r}: max "
            f"relative error {rel.max():.3e} (tol {rtol:.0e})")
        if not (rel <= rtol).all():
            fail(f"{label}: eigenvalues {vals!r} vs closed form {want!r}")

    def gate_converged(label, run, maxiter):
        """Converged below EIG_TOL, the plain run in the same iterations
        and spanning the same subspace to EIG_SUBSPACE_TOL."""
        res = run["res"]
        rn = np.asarray(res.resnorms.cpu() if isinstance(res.resnorms,
                                                         torch.Tensor)
                        else res.resnorms)
        conv = getattr(res, "converged", bool((rn <= EIG_TOL).all()))
        log(f"{label}: converged {conv}, residual norms {rn!r} (tol "
            f"{EIG_TOL:.0e})")
        if not (conv and run["iters"] < maxiter and (rn <= EIG_TOL).all()):
            fail(f"{label}: not converged ({run['iters']} iterations, "
                 f"residuals {rn!r})")
        if run["iters"] != run["ref_iters"] or run["sin"] > EIG_SUBSPACE_TOL:
            fail(f"{label}: plain run {run['ref_iters']} iterations against "
                 f"{run['iters']}, subspace sin {run['sin']:.3e}")

    lam_lo = closed_form(DIMS, EIG_NEV)
    lam_hi = closed_form(DIMS, EIG_NEV, largest=True)
    e_need = ("stencil_spmm", "dia_spmm", "chol_inv_small")
    # e1 — LOBPCG SR with the AMG V-cycle (the headline), e2 — Block
    # Davidson SR with the same preconditioner
    for label, name in (("e1 LOBPCG + AMG", "LOBPCG"),
                        ("e2 Block Davidson + AMG", "BLOCK_DAVIDSON")):
        st_, ar_ = eigen_entry(name, {"Which": "SR",
                                      "Convergence Tolerance": EIG_TOL},
                               nev=EIG_NEV, amg=amg64)
        run = eig_run(label.split()[0], f"{label} {GRID} f64", st_, ar_,
                      need=e_need)
        gate_converged(label, run, 200)
        gate_closed(label, run["vals"], lam_lo)
        del st_, ar_
    # e3 — Block Krylov-Schur LM, block size 2, at a fixed restart budget:
    # the basis stays on the card; the largest copy to the host is recorded
    bks_params = {"Which": "LM", "Block Size": 2, "Convergence Tolerance": 0.0,
                  "Maximum Restarts": BKS_RESTARTS}

    @contextlib.contextmanager
    def host_pulls():
        """The largest device-to-host copy (elements) made through
        Tensor.cpu() or Tensor.to() inside the block."""
        biggest = [0]
        real_cpu, real_to = torch.Tensor.cpu, torch.Tensor.to

        def cpu(self, *a, **k):
            if self.is_cuda:
                biggest[0] = max(biggest[0], self.numel())
            return real_cpu(self, *a, **k)

        def to(self, *a, **k):
            out = real_to(self, *a, **k)
            if self.is_cuda and not out.is_cuda:
                biggest[0] = max(biggest[0], self.numel())
            return out

        with mock.patch.object(torch.Tensor, "cpu", cpu), \
                mock.patch.object(torch.Tensor, "to", to):
            yield biggest

    def rss_gib():
        for line in pathlib.Path("/proc/self/status").read_text().splitlines():
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 2 ** 20
        return float("nan")

    e3step, e3args = eigen_entry("Block Krylov Schur", bks_params,
                                 nev=EIG_NEV, dims=DIMS)
    rss0 = rss_gib()
    with host_pulls() as pulled:
        e3 = eig_run("e3", f"e3 Block Krylov-Schur LM {GRID} f64, "
                     f"{BKS_RESTARTS} restarts", e3step, e3args,
                     need=("stencil_spmm", "chol_inv_small"))
    rss1 = rss_gib()
    m_bks = 20  # the default basis: min(max(2·nev + 12, 20), n − nb)
    lead = float(np.max(np.real(e3["vals"])))
    log(f"e3 Block Krylov-Schur: {e3['iters']} Arnoldi steps (plain "
        f"{e3['ref_iters']}, expected {BKS_STEPS}); leading Ritz value "
        f"{lead!r} against λmax {lam_hi[0]!r} (Δ {lam_hi[0] - lead:.3e}); "
        f"Ritz residual estimates {e3['res'].resnorms!r}; the largest copy "
        f"to the host {pulled[0]} elements (basis {n64} x {m_bks}: "
        f"{n64 * m_bks}); host RSS {rss0:.2f} -> {rss1:.2f} GiB")
    if not (e3["iters"] == e3["ref_iters"] == BKS_STEPS):
        fail(f"e3: {e3['iters']} and {e3['ref_iters']} steps, not "
             f"{BKS_STEPS}")
    if not lam_hi[0] - BKS_LEAD_WINDOW <= lead <= lam_hi[0] * (1 + 1e-12):
        fail(f"e3: leading Ritz value {lead!r} outside [λmax − "
             f"{BKS_LEAD_WINDOW}, λmax]")
    if pulled[0] > (m_bks + 2) * m_bks:
        fail(f"e3: a copy of {pulled[0]} elements went to the host")
    # e3b — the same Block Krylov-Schur at rtol 1e-8 where the JAX package
    # converges within its 20 restarts, beside its CPU count (gated within
    # one restart's 12 steps)
    st_, ar_ = eigen_entry("Block Krylov Schur", {"Which": "LM",
                                                  "Block Size": 2},
                           nev=EIG_NEV, dims=BKS_CONV_DIMS)
    grid_b = "x".join(map(str, BKS_CONV_DIMS))
    run = eig_run("e3b", f"e3b Block Krylov-Schur LM {grid_b} f64", st_,
                  ar_, need=("stencil_spmm",))
    log(f"e3b: {run['iters']} Arnoldi steps (JAX package, CPU f64: "
        f"{BKS_CONV_CPU_STEPS})")
    if not run["res"].converged or abs(run["iters"]
                                       - BKS_CONV_CPU_STEPS) > 12:
        fail(f"e3b: converged {run['res'].converged} in {run['iters']} "
             f"steps (CPU {BKS_CONV_CPU_STEPS})")
    # a block of 2 sees at most two vectors of an eigenspace: the reference
    # returns λmax, two copies of the triple λ₂ and then λ₅ (the JAX package
    # too); every value is held to the spectrum, the leading to λmax
    spec_b = laplace_spectrum(BKS_CONV_DIMS)
    gate_closed("e3b leading value", run["vals"][:1], spec_b[-1:])
    gate_closed("e3b values", run["vals"], [
        spec_b[np.argmin(np.abs(spec_b - v))] for v in np.real(run["vals"])])
    # e4 — TraceMin, RTR, LANCZOS and POWER through eigen_entry, and
    # Generalized Davidson on config 3's recirc2d through the factory
    grid_s = "x".join(map(str, EIG_SMALL_DIMS))
    lo_s = closed_form(EIG_SMALL_DIMS, EIG_NEV)
    hi_s = closed_form(EIG_SMALL_DIMS, 1, largest=True)[0]
    for name, params in EIG_SMALL_CASES:
        st_, ar_ = eigen_entry(name, params, nev=EIG_NEV,
                               dims=EIG_SMALL_DIMS)
        run = eig_run(f"e4 {name}", f"e4 {name} {grid_s} f64", st_, ar_,
                      need=(("stencil_spmv",) if name in ("LANCZOS", "POWER")
                            else ("stencil_spmm", "chol_inv_small")))
        log(f"e4 {name}: {run['iters'] or params['Num Blocks']} "
            f"iterations, leading value "
            f"{run['vals'][0]!r} (JAX package, CPU f64: {EIG_CPU[name]}"
            + (f", {EIG_CPU_VALUES[name]!r})" if name in EIG_CPU_VALUES
               else ")"))
        if name in ("TraceMin", "RTR"):
            gate_converged(f"e4 {name}", run, 100)
            gate_closed(f"e4 {name}", run["vals"], lo_s)
        elif name == "LANCZOS":
            gate_closed("e4 LANCZOS leading Ritz value",
                        run["vals"][:1], [hi_s], rtol=EIG_LANCZOS_RTOL)
        elif not (run["iters"] == run["ref_iters"] == params[
                "Maximum Iterations"] and run["vals"][0] <= hi_s):
            fail(f"e4 POWER: {run['iters']} iterations, λ {run['vals']!r}")
        del st_, ar_
    a_gd = recirc2d(CONFIG3_NX, CONFIG3_NX)
    ell_gd = csr_to_ell(a_gd, device="cuda")
    v_gd = np.zeros((ell_gd.n_rows_pad, EIG_NEV))
    v_gd[:a_gd.shape[0]] = np.random.default_rng(7).standard_normal(
        (a_gd.shape[0], EIG_NEV))
    gd_mgr = create_eigensolver("Generalized Davidson", {
        "Which": "LM", "Maximum Iterations": EIG_GD_ITERS})

    def gd_step(v0):
        return gd_mgr.solve(EigenProblem(
            op=lambda v: matvec.spmv(ell_gd, v), n=ell_gd.n_rows_pad,
            nev=EIG_NEV, symmetric=False, v0=v0, device="cuda"))

    grid_gd = f"{CONFIG3_NX}x{CONFIG3_NX}"
    run = eig_run("e4 Generalized Davidson",
                  f"e4 Generalized Davidson LM recirc2d {grid_gd} f64, "
                  f"{EIG_GD_ITERS} iterations", gd_step,
                  (torch.from_numpy(v_gd).to("cuda"),),
                  need=("chol_inv_small",))
    log(f"e4 Generalized Davidson: Ritz values {run['vals']!r}, max |θ| "
        f"{np.abs(run['vals']).max()!r} (JAX package, CPU f64: "
        f"{EIG_CPU['Generalized Davidson']} iterations, max |θ| "
        f"{EIG_CPU_VALUES['Generalized Davidson']!r}); residuals "
        f"{run['res'].resnorms!r}")
    if not (run["iters"] == run["ref_iters"] == EIG_GD_ITERS
            and np.isfinite(run["vals"]).all()):
        fail(f"e4 Generalized Davidson: {run['iters']} iterations, values "
             f"{run['vals']!r}")
    # e5 — the pencil K x = λ M x, M the tensor Q1 mass (a 27-point
    # StencilOp): LOBPCG with the AMG V-cycle at 256³, Block Davidson with
    # the AMG V-cycle of an EIG_SMALL_DIMS hierarchy (unpreconditioned it
    # does not converge there within 200 iterations in the JAX package
    # either); its whitening reaches chol_inv_small at k up to 24
    st_, ar_ = eigen_entry("LOBPCG", {"Which": "SR",
                                      "Convergence Tolerance": EIG_TOL},
                           nev=EIG_NEV, amg=amg64, mass=mass64)
    run = eig_run("e5 LOBPCG", f"e5 LOBPCG + AMG, Q1 mass pencil {GRID} f64",
                  st_, ar_, need=e_need)
    gate_converged("e5 LOBPCG pencil", run, 200)
    gate_closed("e5 LOBPCG pencil", run["vals"],
                closed_form(DIMS, EIG_NEV, mass=True))
    del st_, ar_
    mass_s = StencilOp.create(EIG_SMALL_DIMS, mass27_stencil(),
                              dtype="float64")
    amg_s, _ = setup(f"{grid_s} f64 hierarchy (Block Davidson pencil)",
                     lambda: SaAmg(laplace3d(*EIG_SMALL_DIMS, dtype=np.float64,
                                             fmt="stencil"),
                                   {"dtype": np.float64},
                                   device="cuda").compute())
    st_, ar_ = eigen_entry("Block Davidson", {"Which": "SR",
                                              "Convergence Tolerance":
                                                  EIG_TOL},
                           nev=EIG_NEV, amg=amg_s, mass=mass_s)
    run = eig_run("e5 Block Davidson",
                  f"e5 Block Davidson + AMG, Q1 mass pencil {grid_s} f64",
                  st_, ar_, need=e_need)
    log(f"e5 Block Davidson pencil: {run['iters']} iterations (JAX package, "
        f"CPU f64: {EIG_CPU['Block Davidson mass']})")
    gate_converged("e5 Block Davidson pencil", run, 200)
    gate_closed("e5 Block Davidson pencil", run["vals"],
                closed_form(EIG_SMALL_DIMS, EIG_NEV, mass=True))
    del st_, ar_
    # e6 — shift-invert: eigs_near between the two smallest eigenvalues
    # (Lanczos on (A − σI)⁻¹, inner MINRES at rtol 1e-10)
    lam2 = closed_form(EIG_SMALL_DIMS, 2)
    sigma = lam2[0] + 0.3 * (lam2[1] - lam2[0])
    op_s = laplace3d(*EIG_SMALL_DIMS, dtype=np.float64, fmt="stencil")
    v_s = np.zeros(op_s.n_rows_pad)
    v_s[:op_s.n_rows] = np.random.default_rng(7).standard_normal(
        op_s.n_rows)
    run = eig_run("e6", f"e6 eigs_near sigma {sigma:.6e} {grid_s} f64",
                  lambda v: eigs_near(lambda x: matvec.spmv(op_s, x), sigma,
                                      2, v),
                  (torch.from_numpy(v_s).to("cuda"),), need=("stencil_spmv",))
    log(f"e6 eigs_near (JAX package, CPU f64: {EIG_CPU['eigs_near']} "
        "Lanczos steps)")
    gate_closed("e6 eigs_near", run["vals"], lam2)
    eig_total_s = time.perf_counter() - t_eig
    log(f"eigensolver phases: {eig_total_s:.1f} s with their set-up "
        f"({eig_setup_s:.2f} s)")

    at("7y")
    # -- 7y. the FE discretisation layer: Q1 Poisson on FEM_GRID hexahedra --
    # (fem_poisson_entry: the mesh, assembly and Dirichlet condensation on
    # the host, K_ii as 27-diagonal DIA, uncoupled SA-AMG PCG at rtol
    # FEM_RTOL, assembled and matrix-free; then the manufactured solution
    # and the VTK round trip)
    from trilinos_tpu_torch.entry import (FEM_RTOL, fem_poisson_entry,
                                          fem_poisson_problem)
    from trilinos_tpu_torch.io import read_vtk, write_vtk
    from trilinos_tpu_torch.ops.fe import fe_apply_local

    t_fem = time.perf_counter()
    fem_mem0 = torch.cuda.memory_allocated()
    grid_f = "x".join(map(str, FEM_GRID))
    fprob = fem_poisson_problem(FEM_GRID)
    (fem_step, (fem_b, fem_st)), _ = setup(
        f"FE Q1 Poisson {grid_f} uncoupled hierarchy",
        lambda: fem_poisson_entry(FEM_GRID, problem=fprob))
    fmf, _ = fem_poisson_entry(FEM_GRID, amg=fem_step.preconditioner,
                               matrix_free=True, problem=fprob)
    fop = fem_step.operator
    n_f = fop.n_rows
    fsetup = {**fem_step.setup, **fmf.setup}
    log(f"FE Q1 Poisson {grid_f}: {len(fprob.mesh.connect)} hexahedra, "
        f"{len(fprob.coords)} nodes, K_ii {n_f} rows x {len(fop.offsets)} "
        f"diags ({type(fop).__name__}, {fprob.kii.nnz} nonzeros), levels "
        f"{[type(lv['a']).__name__ for lv in fem_st['levels']]}; set-up "
        f"mesh+assembly {fsetup['mesh_assembly']:.2f} s, format "
        f"{fsetup['format']:.2f} s, AMG {fsetup['amg']:.2f} s, matrix-free "
        f"elements to the card {fsetup['elements']:.2f} s; device memory "
        f"held by the path (K_ii, the hierarchy, the element matrices) "
        f"{(torch.cuda.memory_allocated() - fem_mem0) / 2 ** 30:.3f} GiB")
    if not (isinstance(fop, DiaMatrix) and len(fop.offsets) == 27
            and n_f == int(np.prod([d - 1 for d in FEM_GRID]))):
        fail(f"FE Q1 K_ii: {type(fop).__name__} with "
             f"{len(getattr(fop, 'offsets', ()))} diagonals, {n_f} rows")
    xf = torch.zeros(fop.n_rows_pad, dtype=torch.float64, device="cuda")
    xf[:n_f] = randn(n_f, torch.float64, seed=90)
    fem_err = check(f"dia, FE Q1 K_ii {grid_f} ({n_f} rows x 27 diags) f64",
                    dia_spmv(fop, xf), dia_spmv_plain(fop, xf), FEM_CHECK_TOL)
    check(f"fe_apply_local K_ii (matrix-free) vs the assembled apply, "
          f"{grid_f} f64", fmf.apply(xf), dia_spmv_plain(fop, xf),
          FEM_CHECK_TOL)
    fcsr = csr_f64(fprob.kii)
    fem_runs = {}
    for label, st_ in (("assembled", fem_step), ("matrix-free", fmf)):
        torch.cuda.reset_peak_memory_stats()
        in_use = torch.cuda.memory_allocated()
        fem_res, fem_first, flaunch = drive(st_, (fem_b, fem_st))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st_(fem_b, fem_st)
        torch.cuda.synchronize()
        fem_warm = (time.perf_counter() - t0) * 1e3
        fem_true = host_residual(fcsr, fem_res.x, fem_b)
        frun = dict(iters=int(fem_res.iters),
                    converged=bool(fem_res.converged), first=fem_first,
                    warm=fem_warm, true=fem_true, launches=flaunch,
                    peak=(torch.cuda.max_memory_allocated() - in_use)
                    / 2 ** 30)
        fem_runs[label] = frun
        log(f"FE Q1 Poisson {grid_f} AMG-PCG, {label}: converged "
            f"{frun['converged']} iters {frun['iters']}; true relative "
            f"residual {fem_true:.3e} (gate {FEM_RTOL:.0e}); first solve "
            f"{fem_first:.1f} ms, warm {fem_warm:.2f} ms "
            f"({fem_warm / max(frun['iters'], 1):.3f} ms/iter); the solves' "
            f"own peak device memory {frun['peak']:.3f} GiB (above "
            f"{in_use / 2 ** 30:.2f} GiB in use before); launches {flaunch}")
        if not (frun["converged"] and fem_true <= FEM_RTOL):
            fail(f"FE Q1 Poisson {label}: converged {frun['converged']}, "
                 f"true residual {fem_true:.3e}")
        if not flaunch.get("dia_spmv"):
            fail(f"FE Q1 Poisson {label}: dia_kernel was never launched")
    if abs(fem_runs["assembled"]["iters"]
           - fem_runs["matrix-free"]["iters"]) > 1:
        fail(f"FE Q1 Poisson: assembled {fem_runs['assembled']['iters']} "
             f"and matrix-free {fem_runs['matrix-free']['iters']} "
             "iterations differ by more than 1")
    mres, _, _ = drive(fem_step, (fem_step.load, fem_st))
    fem_nodal_err = float(np.abs(mres.x[:n_f].cpu().numpy()
                                 - fprob.exact).max())
    log(f"FE Q1 Poisson {grid_f} manufactured solution sin(πx)sin(πy)sin(πz)"
        f": {int(mres.iters)} iterations, max nodal error "
        f"{fem_nodal_err:.3e} at h = 1/{FEM_GRID[0]} (gate "
        f"{FEM_NODAL_MAX:.0e})")
    if not (bool(mres.converged) and fem_nodal_err <= FEM_NODAL_MAX):
        fail(f"FE Q1 Poisson manufactured solution: error "
             f"{fem_nodal_err:.3e}")
    # the element apply alone and the matrix-free K_ii apply, host path
    # (CUDA events around BATCH calls): the element matrices are read once
    fconn = torch.from_numpy(fprob.connect).to("cuda")
    fke = torch.from_numpy(fprob.elements).to("cuda")
    xn = randn(len(fprob.coords), torch.float64, seed=91)
    fe_ms = time_ms(lambda: fe_apply_local(fconn, fke, xn))
    fe_bytes = (fke.numel() + 2 * xn.numel()) * 8 + fconn.numel() * 8
    fmf_ms = time_ms(lambda: fmf.apply(xf))
    log(f"fe_apply_local {grid_f} f64 ({fke.shape[0]} elements x 8x8): "
        f"{fe_ms:.4f} ms (host path), bound {fe_bytes / HBM_BYTES_PER_MS:.4f}"
        f" ms ({fe_bytes} bytes: element matrices, connectivity, x and y); "
        f"the matrix-free K_ii apply {fmf_ms:.4f} ms; dia_kernel on K_ii is "
        "timed with the kernels below")
    del fconn, fke, xn
    # the solution as a nodal field (zero on the boundary) through VTK
    u_nodes = np.zeros(len(fprob.coords))
    u_nodes[fprob.interior] = mres.x[:n_f].cpu().numpy()
    with tempfile.TemporaryDirectory() as vdir:
        vpath = pathlib.Path(vdir) / "fem_poisson.vtk"
        t0 = time.perf_counter()
        write_vtk(vpath, fprob.mesh, point_data={"u": u_nodes},
                  cell_data={"element": np.arange(len(fprob.mesh.connect),
                                                  dtype=np.float64)})
        vw_s = time.perf_counter() - t0
        vbytes = vpath.stat().st_size
        t0 = time.perf_counter()
        vtopo, vcoords, vconn, vpd, vcd = read_vtk(vpath)
        vr_s = time.perf_counter() - t0
    vtk_ok = (vtopo == "hex8" and np.array_equal(vcoords, fprob.mesh.coords)
              and np.array_equal(vconn, fprob.mesh.connect)
              and np.array_equal(vpd["u"], u_nodes)
              and np.array_equal(vcd["element"],
                                 np.arange(len(fprob.mesh.connect))))
    log(f"VTK round trip of the solution on {grid_f}: {vbytes} bytes, "
        f"write {vw_s:.2f} s, read {vr_s:.2f} s; read back equal: {vtk_ok}")
    if not vtk_ok:
        fail("VTK round trip: the file read back differs")
    del fmf, fcsr, mres, fem_res, u_nodes, vcoords, vconn, vpd, vcd
    fem_total_s = time.perf_counter() - t_fem
    log(f"FE phase: {fem_total_s:.1f} s with its set-up")

    at("7x")
    # -- 7x. the distributed layer: DIST_RANKS rank processes on this card --
    # (gloo; the kernels were built above, before any rank starts, so the
    # ranks load them and never race on the build directory)
    from trilinos_tpu_torch.entry import MD_RTOL
    from trilinos_tpu_torch.parallel import driver as pdrv
    from trilinos_tpu_torch.parallel.map import Map

    log(card)
    log(f"distributed phases: {DIST_RANKS} rank processes share this one "
        "card over the gloo transport, which stages every exchange and "
        "reduction through host memory: their times are not scaling "
        "numbers")
    t0 = time.perf_counter()
    ranks = pdrv.launch(dist_rank_phases, DIST_RANKS, DIST_C4_DIMS,
                        DIST_AMG_DIMS, DIST_SMALL_DIMS, device="cuda",
                        backend="gloo", timeout=900.0)
    dist_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    one = pdrv.launch(dist_rank_c4_one, 1, DIST_C4_DIMS, device="cuda",
                      backend="nccl", timeout=600.0)[0]
    one_s = time.perf_counter() - t0
    log(f"distributed phases: {dist_s:.1f} s for the {DIST_RANKS}-rank "
        f"group, {one_s:.1f} s for the one-rank nccl group (spawn and "
        "set-up included)")
    for key in ranks[0]["err"]:
        errs = [r["err"][key] for r in ranks]
        log(f"check {key}: kernel vs plain on each rank's data, max|Δ| "
            f"{errs} (bitwise)")
        if any(e != 0 for e in errs):
            fail(f"{key}: kernel and plain versions differ on a rank")
    labels = ("c4", "c4_small", "amg", "cheb_fused", "amg_host",
              "amg_blocks")
    for label in labels:
        its = [r[label]["iters"] for r in ranks]
        if len(set(its)) != 1 or not all(r[label]["converged"]
                                         for r in ranks):
            fail(f"distributed {label}: iterations {its}, converged "
                 f"{[r[label]['converged'] for r in ranks]}")
    grid_c4 = "x".join(map(str, DIST_C4_DIMS))
    c4d = [r["c4"] for r in ranks]
    n_c4 = int(np.prod(DIST_C4_DIMS))
    rmap4 = Map.uniform(n_c4, DIST_RANKS)
    xd = torch.from_numpy(rmap4.from_padded(np.concatenate(
        [r["x"] for r in c4d]))).to("cuda")
    c4_rel, _ = rel_err(xd, c4x[:n_c4])
    c4d_true = host_residual(c4csr, xd, c4b)
    for s_, r in enumerate(c4d):
        idle = (1.0 - r["busy_ms"] / r["warm_ms"]) if r["warm_ms"] else None
        log(f"config 4 distributed rank {s_}: {r['rows']} rows x "
            f"{r['diags']} diags (DIA interior), {r['mode']} exchange of "
            f"{r['halo_rows']} halo rows an apply; set-up "
            f"{r['setup_s']:.2f} s; first solve {r['ms']:.1f} ms, "
            f"{r['ms'] / r['iters']:.4f} ms/iter; staged through the host "
            f"{r['staged']} bytes; warm solve {r['warm_ms']:.1f} ms "
            f"({r['warm_ms'] / r['iters']:.4f} ms/iter), device time "
            f"{r['busy_ms']:.1f} ms, idle share "
            + (f"{idle:.3f}" if idle is not None else "not measured")
            + f"; launches {r['launches']}")
    log(f"config 4 distributed ({grid_c4} f64, {DIST_RANKS} ranks, "
        f"pipelined CG + dist_jacobi, rtol 1e-8): iters {c4d[0]['iters']} "
        f"(single card {c4iters}, within {DIST_SERIAL_ITERS_TOL}); gathered "
        f"x vs the single-card solution max|Δx|/max|x| = {c4_rel:.3e} (tol "
        f"{DIST_C4_X_TOL:.0e}); true relative residual {c4d_true:.3e} (gate "
        f"{DIST_C4_TRUE_MAX:.0e})")
    if abs(c4d[0]["iters"] - c4iters) > DIST_SERIAL_ITERS_TOL \
            or not c4_rel <= DIST_C4_X_TOL \
            or not c4d_true <= DIST_C4_TRUE_MAX:
        fail("config 4 distributed: iterations, solution or residual")
    if any(not r["launches"].get("dia_spmv") for r in c4d):
        fail(f"config 4 distributed: a rank never launched dia_kernel: "
             f"{[r['launches'] for r in c4d]}")
    log(f"config 4 on one rank over nccl: backend {one['backend']}, iters "
        f"{one['iters']} (4 ranks: {c4d[0]['iters']}), dia_spmv launches "
        f"{one['launches']}, staged {one['staged']} bytes")
    if one["backend"] != "nccl" or not one["converged"] \
            or abs(one["iters"] - c4d[0]["iters"]) > DIST_SERIAL_ITERS_TOL \
            or abs(one["iters"] - c4iters) > DIST_SERIAL_ITERS_TOL \
            or not one["launches"] or one["staged"]:
        fail(f"config 4 on one nccl rank: {one}")
    # the k = 4 distributed SpMV and transpose against the serial product
    xk_host = np.zeros((c4a.n_rows_pad, DIST_MV_K))
    xk_host[:n_c4] = np.random.default_rng(11).standard_normal(
        (n_c4, DIST_MV_K))
    y_serial = dia_spmm(c4a, torch.from_numpy(xk_host).to("cuda"))[:n_c4]
    for key, label in (("y", "dist_spmv"), ("yt", "dist_spmv_t")):
        got = torch.from_numpy(rmap4.from_padded(np.concatenate(
            [r["mv"][key] for r in ranks]))).to("cuda")
        check(f"{label} k={DIST_MV_K} (gathered) vs the serial DIA SpMM "
              "(Laplace3D is symmetric)", got, y_serial, DIST_MV_TOL)
    grid_s = "x".join(map(str, DIST_SMALL_DIMS))
    for label, cpu_key, what in (
            ("c4_small", "config4", "config 4 (pipelined CG + jacobi)"),
            ("cheb_fused", "cheb_fused", "CG + dist_cheb_fused"),
            ("amg_host", "amg", "CG + dist_amg (host set-up)"),
            ("amg_blocks", "amg_blocks",
             "CG + dist_amg_blocks (distributed set-up)")):
        r = ranks[0][label]
        extra = (f", set-up {r['setup_s']:.2f} s, {r['levels']} levels"
                 if "setup_s" in r else "")
        log(f"distributed {what} on {grid_s} f64: iters {r['iters']} (JAX "
            f"package, CPU f64, {DIST_RANKS} shards: "
            f"{DIST_CPU_ITERS[cpu_key]}), first solve {r['ms']:.1f} ms"
            f"{extra}; launches per rank "
            f"{[q[label]['launches'] for q in ranks]}")
        if r["iters"] != DIST_CPU_ITERS[cpu_key]:
            fail(f"distributed {what}: {r['iters']} iterations, the JAX "
                 f"package's {DIST_CPU_ITERS[cpu_key]}")
    if any(not q["cheb_fused"]["launches"].get("stencil_poly")
           for q in ranks):
        fail("dist_cheb_fused: a rank never launched poly_kernel")
    amg_d = [r["amg"] for r in ranks]
    grid_a = "x".join(map(str, DIST_AMG_DIMS))
    log(f"structured AMG-PCG distributed ({grid_a} f32, {DIST_RANKS} "
        f"ranks, z-slabs {amg_d[0]['slab']}): iters {amg_d[0]['iters']} "
        f"(single card: {iters}); set-up {amg_d[0]['setup_s']:.2f} s; "
        f"first solve {amg_d[0]['ms']:.1f} ms; {amg_d[0]['mode']} exchange "
        f"of {amg_d[0]['halo_rows']} halo rows; staged "
        f"{[r['staged'] for r in amg_d]} bytes; launches per rank "
        f"{[r['launches'] for r in amg_d]}")
    if amg_d[0]["iters"] != iters:
        fail(f"distributed AMG-PCG: {amg_d[0]['iters']} iterations, the "
             f"single card's {iters}")
    if any(not (r["launches"].get("stencil_spmv")
                and r["launches"].get("dia_spmv")) for r in amg_d):
        fail("distributed AMG-PCG: a rank never launched stencil_kernel "
             "and dia_kernel")
    # s-step GMRES over the ranks' z-slabs against the single card's run
    ssd = [r["sstep"] for r in ranks]
    s_single = float(sres.resnorm)
    s_rel = abs(ssd[0]["resnorm"] - s_single) / s_single
    log(f"s-step GMRES distributed ({grid_a} f32, {DIST_RANKS} ranks, "
        f"extended slabs {ssd[0]['slab']}, rank 0's z-bounds {ssd[0]['zb']}):"
        f" iters {[r['iters'] for r in ssd]} (single card {sres.iters}); "
        f"resnorm {ssd[0]['resnorm']!r} (single card {s_single!r}, rel Δ "
        f"{s_rel:.3e}, tol {DIST_SSTEP_RTOL:.0e}); set-up "
        f"{ssd[0]['setup_s']:.2f} s; first solve {ssd[0]['ms']:.1f} ms "
        f"({ssd[0]['ms'] / ssd[0]['iters']:.3f} ms a basis vector); staged "
        f"{[r['staged'] for r in ssd]} bytes; launches per rank "
        f"{[r['launches'] for r in ssd]}; fused poly_kernel launches "
        f"{[r['kernel_launches'] for r in ssd]} (single card "
        f"{s_launches['stencil_powers']})")
    if any(r["iters"] != sres.iters for r in ssd) \
            or not s_rel <= DIST_SSTEP_RTOL:
        fail("distributed s-step GMRES: iterations or residual norm")
    if any(r["launches"]["stencil_powers"] != s_launches["stencil_powers"]
           or r["kernel_launches"] != r["launches"]["stencil_powers"]
           for r in ssd):
        fail("distributed s-step GMRES: poly_kernel launches a rank differ "
             "from the single card's")
    # AMG-LOBPCG over the ranks' z-slabs against the closed form and the
    # single card's e1
    ed = [r["eigen"] for r in ranks]
    e_vals = np.sort(np.asarray(ed[0]["vals"]))
    e_rel = np.abs(e_vals - np.sort(closed_form(DIST_AMG_DIMS, EIG_NEV))) \
        / np.sort(closed_form(DIST_AMG_DIMS, EIG_NEV))
    e1_iters = eig_runs["e1"]["iters"]
    log(f"AMG-LOBPCG distributed ({grid_a} f64, {DIST_RANKS} ranks, slabs "
        f"{ed[0]['slab']}, nev {EIG_NEV}, SM): iters "
        f"{[r['iters'] for r in ed]} (single card e1 {e1_iters}); "
        f"eigenvalues {e_vals!r}, against the closed form max rel "
        f"{e_rel.max():.3e} (tol {EIG_CLOSED_RTOL:.0e}); residual norms "
        f"{np.asarray(ed[0]['resnorms'])!r}; set-up {ed[0]['setup_s']:.2f} s; "
        f"first solve {ed[0]['ms']:.1f} ms ({ed[0]['ms'] / ed[0]['iters']:.1f}"
        f" ms an iteration); staged {[r['staged'] for r in ed]} bytes; "
        f"launches per rank {[r['launches'] for r in ed]}")
    if len({r["iters"] for r in ed}) != 1 \
            or abs(ed[0]["iters"] - e1_iters) > DIST_EIG_ITERS_TOL \
            or not (e_rel <= EIG_CLOSED_RTOL).all():
        fail("distributed AMG-LOBPCG: iterations or eigenvalues")
    if any(not r["launches"].get(k) for r in ed
           for k in ("stencil_spmm", "dia_spmm", "chol_inv_small")):
        fail("distributed AMG-LOBPCG: a rank never launched "
             "stencil_mv_kernel, dia_mv_kernel or chol_inv_small")
    # GMRES(30) with restricted Schwarz on config 4's matrix
    for label, dims in (("schwarz", DIST_C4_DIMS),
                        ("schwarz_small", DIST_SMALL_DIMS)):
        sd = [r[label] for r in ranks]
        grid_l = "x".join(map(str, dims))
        extra, bad = "", False
        if dims == DIST_C4_DIMS:
            xs = torch.from_numpy(rmap4.from_padded(np.concatenate(
                [r["x"] for r in sd]))).to("cuda")
            s_true = host_residual(c4csr, xs, c4b)
            extra = (f"; true relative residual {s_true:.3e} (gate "
                     f"{DIST_C4_TRUE_MAX:.0e})")
            bad = not s_true <= DIST_C4_TRUE_MAX
        else:
            extra = (f" (JAX package, CPU f64, {DIST_RANKS} shards: "
                     f"{DIST_CPU_ITERS['schwarz']})")
            bad = sd[0]["iters"] != DIST_CPU_ITERS["schwarz"]
        log(f"GMRES(30) + restricted Schwarz distributed ({grid_l} f64, "
            f"{DIST_RANKS} ranks, overlap 1, ILU(0) subdomains): iters "
            f"{[r['iters'] for r in sd]}{extra}; set-up "
            f"{sd[0]['setup_s']:.2f} s; first solve {sd[0]['ms']:.1f} ms "
            f"({sd[0]['ms'] / sd[0]['iters']:.3f} ms/iter); staged "
            f"{[r['staged'] for r in sd]} bytes; launches per rank "
            f"{[r['launches'] for r in sd]}")
        if bad or len({r["iters"] for r in sd}) != 1 \
                or not all(r["converged"] for r in sd):
            fail(f"distributed Schwarz GMRES at {grid_l}: iterations, "
                 "convergence or residual")
        if any(not r["launches"].get("dia_spmv") for r in sd):
            fail(f"distributed Schwarz GMRES at {grid_l}: a rank never "
                 "launched dia_kernel")
    # (a) config 4 on the (2, 2) rank grid against the flat layout
    cg_ = [r["c4_grid"] for r in ranks]
    log(f"config 4 on a (2, 2) rank grid ({grid_c4} f64, make_mesh2, axes "
        f"{cg_[0]['axes']}, coordinates {[r['coords'] for r in cg_]}): "
        f"iters {[r['iters'] for r in cg_]} (flat layout "
        f"{c4d[0]['iters']}); max|x − flat x| a rank "
        f"{[r['x_diff'] for r in cg_]}, right-hand sides "
        f"{[r['b_diff'] for r in cg_]}; set-up {cg_[0]['setup_s']:.2f} s; "
        f"first solve {cg_[0]['ms']:.1f} ms; staged "
        f"{[r['staged'] for r in cg_]} bytes; launches per rank "
        f"{[r['launches'] for r in cg_]}")
    if any(r["iters"] != c4d[0]["iters"] or r["x_diff"] != 0
           or r["b_diff"] != 0 or not r["converged"] for r in cg_):
        fail("config 4 on the rank grid: iterations or x differ from the "
             "flat layout's")
    if any(not r["launches"].get("dia_spmv") for r in cg_):
        fail("config 4 on the rank grid: a rank never launched dia_kernel")
    # (b) Laplace3D through Domi's MDMap on the DIST_MD_GRID rank grid
    md_ = [r["md"] for r in ranks]
    x_md = np.zeros(DIST_AMG_DIMS, np.float32)
    for r in md_:
        x_md[tuple(slice(c * d, (c + 1) * d)
                   for c, d in zip(r["coords"], r["block"]))] = r["x"]
    b_md = np.random.default_rng(0).standard_normal(DIST_AMG_DIMS)
    csr_md = torch.sparse_csr_tensor(
        torch.from_numpy(a256.row_ptr),
        torch.from_numpy(a256.cols.astype(np.int64)),
        torch.from_numpy(a256.vals.astype(np.float64)), a256.shape).to("cuda")
    b64 = torch.from_numpy(b_md.reshape(-1)).to("cuda")
    md_true = float(torch.linalg.vector_norm(
        b64 - csr_md @ torch.from_numpy(x_md.reshape(-1)).to("cuda").double())
        / torch.linalg.vector_norm(b64))
    del csr_md, b64, x_md, b_md
    log(f"md CG on a {DIST_MD_GRID} rank grid ({grid_a} f32, blocks "
        f"{md_[0]['block']} padded to {md_[0]['padded']}, CA Chebyshev "
        f"degree 3, rtol {MD_RTOL:.0e}): iters {[r['iters'] for r in md_]}, "
        f"converged {[r['converged'] for r in md_]}; true relative residual "
        f"(host CSR, f64) {md_true:.3e} (gate {DIST_MD_TRUE_MAX:.0e}); "
        f"set-up {md_[0]['setup_s']:.2f} s; first solve {md_[0]['ms']:.1f} "
        f"ms ({md_[0]['ms'] / md_[0]['iters']:.3f} ms/iter); staged "
        f"{[r['staged'] for r in md_]} bytes; launches per rank "
        f"{[r['launches'] for r in md_]}")
    if len({r["iters"] for r in md_}) != 1 \
            or not all(r["converged"] for r in md_) \
            or not md_true <= DIST_MD_TRUE_MAX:
        fail("md CG: iterations, convergence or true residual")
    if any(not r["launches"].get("stencil_spmv") for r in md_):
        fail("md CG: a rank never launched stencil_kernel")
    ms_ = [r["md_small"] for r in ranks]
    log(f"md CG on a {DIST_MD_GRID} rank grid ({grid_s} f64): iters "
        f"{[r['iters'] for r in ms_]} (JAX package, CPU f64, a "
        f"{DIST_MD_GRID} mesh: {DIST_MD_CPU_ITERS}); first solve "
        f"{ms_[0]['ms']:.1f} ms; launches per rank "
        f"{[r['launches'] for r in ms_]}")
    if any(r["iters"] != DIST_MD_CPU_ITERS or not r["converged"]
           or not r["launches"].get("stencil_spmv") for r in ms_):
        fail(f"md CG at {grid_s}: iterations, convergence or launches")
    # (c) the column-block dense LU
    dn = ranks[0]["dense"]
    log(f"dist_dense_solve (n {DIST_DENSE_N}, nb {DIST_DENSE_NB}, k "
        f"{DIST_DENSE_K}, f64, {DIST_RANKS} ranks): ‖a·x − b‖/‖b‖ "
        f"{dn['res']:.3e} (gate {DIST_DENSE_RES_MAX:.0e}); x vs "
        f"torch.linalg.solve on rank 0 max|Δx|/max|x| {dn['x_rel']:.3e} (tol "
        f"{DIST_DENSE_X_TOL:.0e}); {[r['dense']['ms'] for r in ranks]} ms a "
        f"rank (torch.linalg.solve on one rank {dn['solve_ms']:.1f} ms); "
        f"staged {[r['dense']['staged'] for r in ranks]} bytes")
    if not dn["res"] <= DIST_DENSE_RES_MAX \
            or not dn["x_rel"] <= DIST_DENSE_X_TOL \
            or len({r["dense"]["x_sum"] for r in ranks}) != 1:
        fail("dist_dense_solve: residual, solution or replication")
    # (d) the dryrun's rank body: each kind's iterations and convergence
    # (the gates' rtol 1e-4 within 6 iterations is a coverage gate, not a
    # convergence one) and each eigensolver kind's eigenvalues, the same on
    # every rank
    dr = [r["dryrun"] for r in ranks]
    for k in sorted(dr[0]["solvers"]):
        its = [d["solvers"][k]["iters"] for d in dr]
        rn = [d["solvers"][k]["resnorm"] for d in dr]
        log(f"dryrun solver kind {k}: iters {its}, converged "
            f"{[d['solvers'][k]['converged'] for d in dr]}, residual norm "
            f"{rn[0]!r}")
        if len(set(its)) != 1 or len(set(rn)) != 1 \
                or not np.isfinite(rn[0]):
            fail(f"dryrun solver kind {k}: iterations {its}, residual norms "
                 f"{rn}")
    for k in sorted(dr[0]["eigen"]):
        vals = [d["eigen"][k] for d in dr]
        log(f"dryrun eigensolver kind {k}: eigenvalues {vals[0]!r}")
        if not (np.isfinite(vals[0]).all()
                and all(np.array_equal(v, vals[0]) for v in vals)):
            fail(f"dryrun eigensolver kind {k}: eigenvalues {vals}")
    log(f"dryrun rank body ({DIST_RANKS} ranks): "
        f"{[round(d['seconds'], 2) for d in dr]} s a rank, its distributed "
        f"solves' iterations {dr[0]['steps']}")
    dist_rows = []
    for key, name, source, replaces, also, label, launch_key in (
            ("c4", "dia_spmv", "dia_spmv.cu", "dia_spmv.py:273",
             "dia_spmv.py:524", "c4", "dia_spmv"),
            ("amg", "stencil_spmv", "stencil_spmv.cu", "stencil_op.py:475",
             "stencil_op.py:702", "amg", "stencil_spmv"),
            ("poly", "stencil_poly", "stencil_poly.cu",
             "stencil_poly.py:336", None, "cheb_fused", "stencil_poly"),
            ("sstep", "stencil_powers", "stencil_poly.cu",
             "stencil_poly.py:336", None, "sstep", "stencil_powers"),
            ("eigen", "stencil_spmm", "stencil_spmv.cu", "stencil_op.py:654",
             None, "eigen", "stencil_spmm"),
            ("md", "stencil_spmv", "stencil_spmv.cu", "stencil_op.py:475",
             "stencil_op.py:702", "md", "stencil_spmv")):
        t = ranks[0]["timing"][key]
        per_rank = [r[label]["launches"].get(launch_key, 0) for r in ranks]
        errs = [v for k, v in ranks[0]["err"].items()
                if k.startswith(label.split("_")[0])]
        dist_rows.append(dict(
            t, name=name, source=source, replaces=replaces,
            also_replaces=also, launches=sum(per_rank),
            launches_per_rank=per_rank,
            per_step=per_rank[0] / max(ranks[0][label]["iters"], 1),
            err=max(errs) if errs else 0.0))

    at("7z")
    # -- 7z. the application layer: derivative rules, JFNK, Phalanx, Piro, ROL
    # (bratu_entry on the CG path's hierarchy, each solve again through the
    # plain versions; every path driven with the counts at 0 just before)
    log(card)

    def host_state(when):
        """What the phase's host-paced solves share with the earlier
        sections: device memory held, the allocator's retries (each frees
        the cache and calls cudaMalloc again), live child processes and
        threads."""
        stats = torch.cuda.memory_stats()
        log(f"application phase {when}: device memory allocated "
            f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB, reserved "
            f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB of "
            f"{torch.cuda.get_device_properties(0).total_memory / 2 ** 30:.2f}"
            f"; allocator retries {stats.get('num_alloc_retries', 0)}, "
            f"cudaMalloc calls {stats.get('num_device_alloc', 'n/a')}; "
            f"child processes "
            f"{len(multiprocessing.active_children())}; threads "
            f"{threading.active_count()}")

    host_state("start")
    app = application_phase(dict(fine=fine, amg=amg, a1=a1, a0=a0,
                                 setup=setup, drive=drive,
                                 plain_run=plain_run))
    host_state("end")

    at("8")
    # -- 8. timings at the main paths' shapes --------------------------------
    torch.backends.cudnn.allow_tf32 = False
    n0, n1, nd = fine.n_rows_pad, a1.n_rows_pad, len(a1.offsets)
    nnz1 = int((a1.data != 0).sum())
    x0 = randn(n0, torch.float32, seed=30)
    x0k = randn((n0, NRHS), torch.float32, seed=31)
    x0b = x0k[:fine.n_rows].T.contiguous()  # the batch layout of conv3d
    x1k = randn((n1, NRHS), torch.float32, seed=32)
    p16 = randn((4096, NRHS), torch.float32, seed=33)
    g16 = with_floor(p16.T @ p16)
    eye16 = torch.eye(NRHS, device="cuda")
    # the library calls sum in another order than the kernels, hence 1e-5
    conv, conv_k = stencil_conv(fine), stencil_conv(fine, NRHS)
    check("conv3d library call vs stencil", conv(x0).reshape(-1),
          stencil_spmv_plain(fine, x0)[:fine.n_rows], 1e-5)
    check("conv3d batch-of-k library call vs stencil SpMM",
          conv_k(x0b).reshape(NRHS, -1).T,
          stencil_spmv_plain(fine, x0k)[:fine.n_rows], 1e-5)
    def poly_flops(stages):
        """Operations of the stage chain on the fine grid: 2 per stencil
        term and 1 for α, 2 each for the β, γ and ζ terms."""
        return sum((2 * fine.nnz + n0 if a else 0)
                   + 2 * n0 * ((bt != 0) + (g != 0) + (z != 0))
                   for a, bt, g, z in stages)

    zero0 = torch.zeros_like(x0)
    w_x0 = stencil_spmv(fine, x0)
    pq = randn((2, n0), torch.float32, seed=34)
    cg_state = (zero0, x0, w_x0, pq[0], pq[1], torch.stack(
        [x0 @ x0, x0 @ w_x0, x0 @ x0 * 1.25, zero0[0] + 0.5]).reshape(1, 4))
    csr = dia_as_csr(a1)
    check("sparse CSR library call vs dia", csr @ x1,
          dia_spmv_plain(a1, x1), 1e-5)
    check("sparse CSR @ dense library call vs dia SpMM", csr @ x1k,
          dia_spmv_plain(a1, x1k), 1e-5)

    def chol_library():
        l, _ = torch.linalg.cholesky_ex(g16)
        return torch.linalg.solve_triangular(l, eye16, upper=False)

    check("cholesky_ex + solve_triangular library call vs chol_inv_small",
          chol_library(), chol_inv_small_plain(g16)[1], 1e-4)
    xe0 = bdia_x(a0, 1, 550)
    xp3 = bdia_x(a3, 1, 551, planes=True)
    x3 = bdia_x(a3, 1, 551)
    csr_e0, csr3 = bdia_as_csr(a0), bdia_as_csr(a3)
    check("sparse CSR library call vs bdia (elasticity level 0)",
          csr_e0 @ xe0, bdia_spmv_plain(a0, xe0), 1e-5)
    check("sparse CSR library call vs bdia (plane CG operator)", csr3 @ x3,
          bdia_spmv_plain(a3, x3), 1e-5)

    def nonzeros(a):
        return int((a.data != 0).sum())
    rows = [
        dict(name="stencil_spmv", source="stencil_spmv.cu",
             replaces="stencil_op.py:475", also_replaces="stencil_op.py:702",
             shape=f"{GRID} f32", bytes=2 * n0 * 4, flops=2 * fine.nnz,
             kernel=lambda: stencil_spmv(fine, x0),
             plain=lambda: stencil_spmv_plain(fine, x0),
             library=lambda: conv(x0)),
        dict(name="dia_spmv", source="dia_spmv.cu",
             replaces="dia_spmv.py:273", also_replaces="dia_spmv.py:524",
             shape=f"level 1, {n1} rows x {nd} diags f32",
             bytes=(nd + 2) * n1 * 4, flops=2 * nnz1,
             kernel=lambda: dia_spmv(a1, x1),
             plain=lambda: dia_spmv_plain(a1, x1),
             library=lambda: csr @ x1),
        dict(name="stencil_spmm", source="stencil_spmv.cu",
             replaces="stencil_op.py:654", also_replaces=None,
             shape=f"{GRID} x k={NRHS} f32 (library: conv3d on a "
                   f"({NRHS}, 1, {', '.join(map(str, DIMS[::-1]))}) batch)",
             bytes=2 * n0 * NRHS * 4, flops=2 * fine.nnz * NRHS,
             kernel=lambda: stencil_spmm(fine, x0k),
             plain=lambda: stencil_spmv_plain(fine, x0k),
             library=lambda: conv_k(x0b)),
        dict(name="dia_spmm", source="dia_spmv.cu",
             replaces="dia_spmv.py:273", also_replaces="dia_spmv.py:430",
             shape=f"level 1, {n1} rows x {nd} diags x k={NRHS} f32",
             bytes=(nd + 2 * NRHS) * n1 * 4, flops=2 * nnz1 * NRHS,
             kernel=lambda: dia_spmm(a1, x1k),
             plain=lambda: dia_spmv_plain(a1, x1k),
             library=lambda: csr @ x1k),
        dict(name="chol_inv_small", source="chol_inv_small.cu",
             replaces="smalldense.py:123", also_replaces=None,
             shape=f"k={NRHS} f32",
             bytes=3 * NRHS * NRHS * 4, flops=2 * NRHS ** 3 // 3,
             kernel=lambda: chol_inv_small(g16),
             plain=lambda: chol_inv_small_plain(g16),
             library=chol_library),
        # no single PyTorch call computes a stencil polynomial or a fused
        # CG iteration: library_ms is null for the last three rows
        dict(name="stencil_poly", source="stencil_poly.cu",
             replaces="stencil_poly.py:336", also_replaces=None,
             shape=f"{GRID} f32, Chebyshev s=3 (u_s only)",
             bytes=2 * n0 * 4, flops=poly_flops(cheb3),
             kernel=lambda: stencil_poly_apply(fine, cheb3, x0),
             plain=lambda: stencil_poly_plain(fine, cheb3, x0),
             library=None),
        dict(name="stencil_powers", source="stencil_poly.cu",
             replaces="stencil_poly.py:336", also_replaces=None,
             shape=f"{GRID} f32, monomial s=4 (all outputs)",
             bytes=(1 + 4) * n0 * 4, flops=poly_flops(mono4),
             kernel=lambda: stencil_powers_apply(fine, mono4, x0),
             plain=lambda: stencil_powers_plain(fine, mono4, x0),
             library=None),
        dict(name="cg_fused", source="cg_fused.cu",
             replaces="cg_fused.py:234", also_replaces=None,
             shape=f"{GRID} f32, one iteration",
             bytes=10 * n0 * 4, flops=12 * n0 + 6 * fine.nnz,
             kernel=lambda: cg_fused_iteration(fine, *cg_state),
             plain=lambda: cg_fused_iteration_plain(fine, *cg_state),
             library=None),
        # the BDIA kernel on its two paths: interleaved k = 1 on the AMG
        # hierarchy (its level 0 here, the other levels logged below) and
        # packed planes in the plane-layout CG
        dict(name="bdia_spmv", source="bdia_spmv.cu",
             replaces="bdia_spmv.py:176", also_replaces=None,
             shape=f"elasticity {grid_e} level 0: b=3, {len(a0.offsets)} "
                   f"offsets, {a0.nbr_pad} block rows, interleaved, f32",
             bytes=bdia_bytes(a0, 1), flops=2 * nonzeros(a0),
             kernel=lambda: bdia_spmv(a0, xe0),
             plain=lambda: bdia_spmv_plain(a0, xe0),
             library=lambda: csr_e0 @ xe0),
        dict(name="bdia_spmm", source="bdia_spmv.cu",
             replaces="bdia_spmv.py:176", also_replaces=None,
             shape=f"elasticity {grid_p}: b=3, {len(a3.offsets)} offsets, "
                   f"{a3.nbr_pad} block rows, planes k=1, f32",
             bytes=bdia_bytes(a3, 1), flops=2 * nonzeros(a3),
             kernel=lambda: bdia_spmm(a3, xp3, layout="planes"),
             plain=lambda: bdia_planes_plain(a3, xp3),
             library=lambda: csr3 @ x3),
    ]
    # each of these rows takes its launches from the path that runs it (CG
    # and block rows from their own paths) and its error from its checks
    launches = {**f_launches, **s_launches, **c_launches, **cg_launches,
                **b_launches, **e_launches, **p_launches}
    # the plane CG has no preconditioner to mark an iteration: its launches
    # per iteration are its launches over its iterations
    p_per = {"bdia_spmm": p_launches["bdia_spmm"] / PLANE_ITERS}
    per_step = {**f_per, **s_per, **c_per, **cg_per, **b_per, **e_per,
                **p_per}
    for r in rows:
        r.update(launches=launches[r["name"]], per_step=per_step[r["name"]],
                 err=err[r["name"]])
    # the ninth slice's shapes, each kernel held to its plain version and
    # each library call to the plain version first: the 7-diagonal 256³ f32
    # operator of build() and the 128³ f64 one of config 4 (DIA, k = 1), and
    # Block GCRODR's k = 4 on the fine grid (stencil SpMM) and level 1 (DIA
    # SpMM)
    x256 = randn(dia256.n_rows_pad, torch.float32, seed=36)
    x4 = randn(c4a.n_rows_pad, torch.float64, seed=37)
    x0k4 = randn((n0, 4), torch.float32, seed=38)
    x0b4 = x0k4[:fine.n_rows].T.contiguous()
    x1k4 = randn((n1, 4), torch.float32, seed=39)
    conv_k4 = stencil_conv(fine, 4)
    csr256, csr4 = dia_as_csr(dia256), dia_as_csr(c4a)
    nd256, nd4 = len(dia256.offsets), len(c4a.offsets)
    new_err = {
        "dia256": check(f"dia {GRID} {dia256.n_rows_pad} rows x {nd256} "
                        "diags f32 (build() operator)", dia_spmv(dia256, x256),
                        dia_spmv_plain(dia256, x256), TOL[torch.float32]),
        "dia4": check(f"dia {grid4} {c4a.n_rows_pad} rows x {nd4} diags f64 "
                      "(config 4)", dia_spmv(c4a, x4), dia_spmv_plain(c4a, x4),
                      TOL[torch.float64]),
        "spmm4": check(f"stencil SpMM {GRID} k=4 f32 (Block GCRODR)",
                       stencil_spmm(fine, x0k4),
                       stencil_spmv_plain(fine, x0k4), 0.0),
        "dia_spmm4": check("dia SpMM level-1 k=4 f32 (Block GCRODR)",
                           dia_spmm(a1, x1k4), dia_spmv_plain(a1, x1k4), 0.0)}
    check("sparse CSR library call vs dia (build() operator)", csr256 @ x256,
          dia_spmv_plain(dia256, x256), 1e-5)
    check("sparse CSR library call vs dia (config 4, f64)", csr4 @ x4,
          dia_spmv_plain(c4a, x4), 1e-12)
    check("conv3d batch-of-4 library call vs stencil SpMM",
          conv_k4(x0b4).reshape(4, -1).T,
          stencil_spmv_plain(fine, x0k4)[:fine.n_rows], 1e-5)
    check("sparse CSR @ dense library call vs dia SpMM k=4", csr @ x1k4,
          dia_spmv_plain(a1, x1k4), 1e-5)
    gcro = block_runs["Block GCRODR"]
    rows += [
        dict(name="dia_spmv", source="dia_spmv.cu",
             replaces="dia_spmv.py:273", also_replaces="dia_spmv.py:524",
             shape=f"{GRID}, {dia256.n_rows_pad} rows x {nd256} diags f32 "
                   "(build() CG + CHEBYSHEV)",
             bytes=(nd256 + 2) * dia256.n_rows_pad * 4,
             flops=2 * nonzeros(dia256),
             kernel=lambda: dia_spmv(dia256, x256),
             plain=lambda: dia_spmv_plain(dia256, x256),
             library=lambda: csr256 @ x256, launches=chlaunch["dia_spmv"],
             per_step=chlaunch["dia_spmv"] / max(chiters, 1),
             err=new_err["dia256"]),
        dict(name="dia_spmv", source="dia_spmv.cu",
             replaces="dia_spmv.py:273", also_replaces="dia_spmv.py:524",
             shape=f"{grid4}, {c4a.n_rows_pad} rows x {nd4} diags f64 "
                   "(BASELINE config 4)",
             bytes=(nd4 + 2) * c4a.n_rows_pad * 8, flops=2 * nonzeros(c4a),
             flops_per_ms=F64_FLOPS_PER_MS,
             kernel=lambda: dia_spmv(c4a, x4),
             plain=lambda: dia_spmv_plain(c4a, x4),
             library=lambda: csr4 @ x4, launches=c4launch["dia_spmv"],
             per_step=c4launch["dia_spmv"] / max(c4iters, 1),
             err=new_err["dia4"]),
        dict(name="stencil_spmm", source="stencil_spmv.cu",
             replaces="stencil_op.py:654", also_replaces=None,
             shape=f"{GRID} x k=4 f32, Block GCRODR (library: conv3d on a "
                   f"(4, 1, {', '.join(map(str, DIMS[::-1]))}) batch)",
             bytes=2 * n0 * 4 * 4, flops=2 * fine.nnz * 4,
             kernel=lambda: stencil_spmm(fine, x0k4),
             plain=lambda: stencil_spmv_plain(fine, x0k4),
             library=lambda: conv_k4(x0b4),
             launches=gcro["spmm_by_k"].get(4, 0),
             per_step=gcro["spmm_by_k"].get(4, 0) / max(gcro["iters"], 1),
             err=new_err["spmm4"]),
        dict(name="dia_spmm", source="dia_spmv.cu",
             replaces="dia_spmv.py:273", also_replaces="dia_spmv.py:430",
             shape=f"level 1, {n1} rows x {nd} diags x k=4 f32, Block GCRODR",
             bytes=(nd + 2 * 4) * n1 * 4, flops=2 * nnz1 * 4,
             kernel=lambda: dia_spmm(a1, x1k4),
             plain=lambda: dia_spmv_plain(a1, x1k4),
             library=lambda: csr @ x1k4,
             launches=gcro["dia_by_k"].get((n1, 4), 0),
             per_step=gcro["dia_by_k"].get((n1, 4), 0) / max(gcro["iters"],
                                                             1),
             err=new_err["dia_spmm4"])]
    # the tenth slice's shapes, each kernel held to its plain version and each
    # library call to the plain version first: the ILU factors' DIA SpMM at
    # k = 2 in f64 (config 3), the uncoupled fine level's DIA SpMV (128³ x 7
    # diagonals, f32) and chol_inv_small at k = 2 in f64 (config 3's CholQR2)
    l3, au0 = ilu3._l, uamg.levels[0]["a"]
    x3k = randn((l3.n_rows_pad, 2), torch.float64, seed=40)
    xu = randn(au0.n_rows_pad, torch.float32, seed=41)
    p2 = randn((4096, 2), torch.float64, seed=42)
    g2 = with_floor(p2.T @ p2)
    eye2 = torch.eye(2, device="cuda", dtype=torch.float64)
    csr_l3, csr_u0 = dia_as_csr(l3), dia_as_csr(au0)
    nd_l3, nd_u0 = len(l3.offsets), len(au0.offsets)

    def chol2_library():
        return torch.linalg.solve_triangular(torch.linalg.cholesky_ex(g2)[0],
                                             eye2, upper=False)

    stored_err = {
        "ilu": check(f"dia SpMM, ILU(0) factor L of recirc2d {grid3} "
                     f"({l3.n_rows_pad} rows x {nd_l3} diags), k=2 f64",
                     dia_spmm(l3, x3k), dia_spmv_plain(l3, x3k), 0.0),
        "uamg": check(f"dia, uncoupled fine level {gridu} ({au0.n_rows_pad} "
                      f"rows x {nd_u0} diags) f32", dia_spmv(au0, xu),
                      dia_spmv_plain(au0, xu), TOL[torch.float32]),
        "chol2": check("chol_inv_small k=2 f64 (config 3's CholQR2)",
                       chol_inv_small(g2)[1], chol_inv_small_plain(g2)[1],
                       CHOL_TOL[torch.float64]["vs_plain"])}
    check("sparse CSR @ dense library call vs dia SpMM (ILU factor, f64)",
          csr_l3 @ x3k, dia_spmv_plain(l3, x3k), 1e-12)
    check("sparse CSR library call vs dia (uncoupled fine level)",
          csr_u0 @ xu, dia_spmv_plain(au0, xu), 1e-5)
    check("cholesky_ex + solve_triangular library call vs chol_inv_small "
          "k=2 f64", chol2_library(), chol_inv_small_plain(g2)[1], 1e-12)
    rows += [
        dict(name="dia_spmm", source="dia_spmv.cu",
             replaces="dia_spmv.py:273", also_replaces="dia_spmv.py:430",
             shape=f"ILU(0) factor L of recirc2d {grid3}, {l3.n_rows_pad} "
                   f"rows x {nd_l3} diags x k=2 f64 (BASELINE config 3)",
             bytes=(nd_l3 + 2 * 2) * l3.n_rows_pad * 8,
             flops=2 * nonzeros(l3) * 2, flops_per_ms=F64_FLOPS_PER_MS,
             kernel=lambda: dia_spmm(l3, x3k),
             plain=lambda: dia_spmv_plain(l3, x3k),
             library=lambda: csr_l3 @ x3k, launches=c3launch["dia_spmm"],
             per_step=c3launch["dia_spmm"] / max(c3steps, 1),
             err=stored_err["ilu"]),
        dict(name="dia_spmv", source="dia_spmv.cu",
             replaces="dia_spmv.py:273", also_replaces="dia_spmv.py:524",
             shape=f"uncoupled SA-AMG fine level {gridu}, {au0.n_rows_pad} "
                   f"rows x {nd_u0} diags f32",
             bytes=(nd_u0 + 2) * au0.n_rows_pad * 4,
             flops=2 * nonzeros(au0), kernel=lambda: dia_spmv(au0, xu),
             plain=lambda: dia_spmv_plain(au0, xu),
             library=lambda: csr_u0 @ xu, launches=u_launches["dia_spmv"],
             per_step=u_per["dia_spmv"], err=stored_err["uamg"]),
        dict(name="chol_inv_small", source="chol_inv_small.cu",
             replaces="smalldense.py:123", also_replaces=None,
             shape="k=2 f64 (BASELINE config 3's CholQR2)",
             bytes=3 * 2 * 2 * 8, flops=2 * 2 ** 3 // 3,
             flops_per_ms=F64_FLOPS_PER_MS,
             kernel=lambda: chol_inv_small(g2),
             plain=lambda: chol_inv_small_plain(g2), library=chol2_library,
             launches=c3launch["chol_inv_small"],
             per_step=c3launch["chol_inv_small"] / max(c3steps, 1),
             err=stored_err["chol2"])]
    # the eleventh slice's shapes: the DIA SpMV on the two-level hybrid's
    # matrix (laplace2d 256², f64) and on the Komplex real form (f64), each
    # held to its plain version, each library call to the plain version
    # first
    x_tl = randn(tlm.a_dev.n_rows_pad, torch.float64, seed=43)
    csr_tl = dia_as_csr(tlm.a_dev)
    nd_tl = len(tlm.a_dev.offsets)
    dslice_err = {"tl": check(
        f"dia, two-level hybrid A of laplace2d {grid_tl} ({nd_tl} diags) "
        f"f64", dia_spmv(tlm.a_dev, x_tl), dia_spmv_plain(tlm.a_dev, x_tl),
        TOL[torch.float64])}
    check("sparse CSR library call vs dia (two-level hybrid A, f64)",
          csr_tl @ x_tl, dia_spmv_plain(tlm.a_dev, x_tl), 1e-12)
    tl_dia = tl_runs["two-level"]["launches"].get("dia_spmv", 0)
    rows.append(dict(
        name="dia_spmv", source="dia_spmv.cu", replaces="dia_spmv.py:273",
        also_replaces="dia_spmv.py:524",
        shape=f"two-level Schwarz hybrid A·x, laplace2d {grid_tl}, "
              f"{tlm.a_dev.n_rows_pad} rows x {nd_tl} diags f64",
        bytes=(nd_tl + 2) * tlm.a_dev.n_rows_pad * 8,
        flops=2 * nonzeros(tlm.a_dev), flops_per_ms=F64_FLOPS_PER_MS,
        kernel=lambda: dia_spmv(tlm.a_dev, x_tl),
        plain=lambda: dia_spmv_plain(tlm.a_dev, x_tl),
        library=lambda: csr_tl @ x_tl, launches=tl_dia,
        per_step=tl_dia / max(tl_runs["two-level"]["iters"], 1),
        err=dslice_err["tl"]))
    if isinstance(kop, DiaMatrix):
        x_k = randn(kop.n_rows_pad, torch.float64, seed=44)
        csr_k = dia_as_csr(kop)
        nd_k = len(kop.offsets)
        dslice_err["komplex"] = check(
            f"dia, Komplex real form {kop.n_rows_pad} rows ({nd_k} diags) "
            f"f64", dia_spmv(kop, x_k), dia_spmv_plain(kop, x_k),
            TOL[torch.float64])
        check("sparse CSR library call vs dia (Komplex real form, f64)",
              csr_k @ x_k, dia_spmv_plain(kop, x_k), 1e-12)
        k_dia = klaunch.get("dia_spmv", 0)
        rows.append(dict(
            name="dia_spmv", source="dia_spmv.cu",
            replaces="dia_spmv.py:273", also_replaces="dia_spmv.py:524",
            shape=f"Komplex real form of laplace2d {grid_k} + "
                  f"{KOMPLEX_SHIFT}i·I, {kop.n_rows_pad} rows x {nd_k} "
                  f"diags f64 (operator and RILUK factors share the count)",
            bytes=(nd_k + 2) * kop.n_rows_pad * 8,
            flops=2 * nonzeros(kop), flops_per_ms=F64_FLOPS_PER_MS,
            kernel=lambda: dia_spmv(kop, x_k),
            plain=lambda: dia_spmv_plain(kop, x_k),
            library=lambda: csr_k @ x_k, launches=k_dia,
            per_step=k_dia / max(int(kres_iters), 1),
            err=dslice_err["komplex"]))
    # the seventeenth slice's shape: the DIA SpMV on the FE Q1 K_ii (27
    # diagonals, f64); launches from both solve forms (the operator of the
    # assembled one and level 0 of the V-cycle in both)
    csr_fe = dia_as_csr(fop)
    check("sparse CSR library call vs dia (FE Q1 K_ii, f64)", csr_fe @ xf,
          dia_spmv_plain(fop, xf), 1e-12)
    fe_dia = sum(r["launches"].get("dia_spmv", 0) for r in fem_runs.values())
    rows.append(dict(
        name="dia_spmv", source="dia_spmv.cu", replaces="dia_spmv.py:273",
        also_replaces="dia_spmv.py:524",
        shape=f"FE Q1 Poisson K_ii on {grid_f} hexahedra, {fop.n_rows_pad} "
              f"rows x {len(fop.offsets)} diags f64 (assembled and "
              f"matrix-free AMG-PCG share the count)",
        bytes=(len(fop.offsets) + 2) * fop.n_rows_pad * 8,
        flops=2 * nonzeros(fop), flops_per_ms=F64_FLOPS_PER_MS,
        kernel=lambda: dia_spmv(fop, xf),
        plain=lambda: dia_spmv_plain(fop, xf),
        library=lambda: csr_fe @ xf, launches=fe_dia,
        per_step=fe_dia / max(sum(r["iters"] for r in fem_runs.values()), 1),
        err=fem_err))
    # the eighteenth slice's shapes: stencil_kernel inside JFNK Bratu (its
    # residuals, 2 a JVP, the V-cycle's fine level), dia_kernel on its
    # coarse levels (level 1 timed; every coarse level shares the count),
    # dia_kernel on Phalanx's K_ii (f64, the V-cycle's fine level)
    jfnk, aph = app["bratu"], app["phalanx"]
    kph, xph = aph["a"], aph["x"]
    csr_ph = dia_as_csr(kph)
    check(f"sparse CSR library call vs dia (Phalanx K_ii {PHALANX_N}², f64)",
          csr_ph @ xph, dia_spmv_plain(kph, xph), 1e-12)
    rows += [
        dict(name="stencil_spmv", source="stencil_spmv.cu",
             replaces="stencil_op.py:475", also_replaces="stencil_op.py:702",
             shape=f"{GRID} f32 inside JFNK Bratu (residuals, 2 a JVP, the "
                   "V-cycle's fine level)",
             bytes=2 * n0 * 4, flops=2 * fine.nnz,
             kernel=lambda: stencil_spmv(fine, x0),
             plain=lambda: stencil_spmv_plain(fine, x0),
             library=lambda: conv(x0),
             launches=jfnk["launches"]["stencil_spmv"],
             per_step=jfnk["launches"]["stencil_spmv"] / jfnk["iters"],
             err=app["err"][f"stencil_spmv {GRID} f32"],
             extra=dict(jvp_host_path_ms=jfnk["jvp_host_path_ms"],
                        jvp_bound_ms=2 * 2 * n0 * 4 / HBM_BYTES_PER_MS)),
        dict(name="dia_spmv", source="dia_spmv.cu",
             replaces="dia_spmv.py:273", also_replaces="dia_spmv.py:524",
             shape=f"level 1, {n1} rows x {nd} diags f32, JFNK Bratu's "
                   "V-cycle (every coarse level shares the count)",
             bytes=(nd + 2) * n1 * 4, flops=2 * nnz1,
             kernel=lambda: dia_spmv(a1, x1),
             plain=lambda: dia_spmv_plain(a1, x1),
             library=lambda: csr @ x1,
             launches=jfnk["launches"]["dia_spmv"],
             per_step=jfnk["launches"]["dia_spmv"] / jfnk["iters"],
             err=app["err"]["dia_spmv level 1 k=1 f32"]),
        dict(name="dia_spmv", source="dia_spmv.cu",
             replaces="dia_spmv.py:273", also_replaces="dia_spmv.py:524",
             shape=f"Phalanx K_ii on {PHALANX_N}² Q1 quadrilaterals, "
                   f"{kph.n_rows_pad} rows x {len(kph.offsets)} diags f64 "
                   "(the JFNK preconditioner's fine level)",
             bytes=(len(kph.offsets) + 2) * kph.n_rows_pad * 8,
             flops=2 * nonzeros(kph), flops_per_ms=F64_FLOPS_PER_MS,
             kernel=lambda: dia_spmv(kph, xph),
             plain=lambda: dia_spmv_plain(kph, xph),
             library=lambda: csr_ph @ xph, launches=aph["launches"],
             per_step=aph["launches"] / max(aph["gmres"], 1),
             err=app["err"]["phalanx K_ii"])]
    # the twelfth slice's shapes (the eigensolvers, f64), each held to its
    # plain version in 7w and each library call to the plain version first
    e1r, e3r = eig_runs["e1"], eig_runs["e3"]
    e5r, e5d = eig_runs["e5 LOBPCG"], eig_runs["e5 Block Davidson"]
    conv_e4 = stencil_conv(fine64, EIG_NEV, torch.float64)
    conv_e2 = stencil_conv(fine64, 2, torch.float64)
    conv_m4 = stencil_conv(mass64, EIG_NEV, torch.float64)
    xe4b, xe2b = xe4.T.contiguous(), xe2.T.contiguous()
    for label, conv_, xb, op_, xk in (
            ("k=4", conv_e4, xe4b, fine64, xe4), ("k=2", conv_e2, xe2b,
                                                   fine64, xe2),
            ("27-point mass k=4", conv_m4, xe4b, mass64, xe4)):
        check(f"conv3d f64 library call vs stencil SpMM {label}",
              conv_(xb).reshape(xk.shape[1], -1).T,
              stencil_spmv_plain(op_, xk), 1e-12)
    a1_64 = levels64[0]
    x1e = randn((a1_64.n_rows_pad, EIG_NEV), torch.float64, seed=99)
    csr1_64 = dia_as_csr(a1_64)
    nd1_64 = len(a1_64.offsets)
    check("sparse CSR @ dense library call vs dia SpMM (f64 level 1, k=4)",
          csr1_64 @ x1e, dia_spmv_plain(a1_64, x1e), 1e-12)

    def chol_lib(g):
        def run():
            l, _ = torch.linalg.cholesky_ex(g)
            return torch.linalg.solve_triangular(
                l, torch.eye(g.shape[0], device=g.device, dtype=g.dtype),
                upper=False)
        return run

    for k in (EIG_NEV, 24):
        check(f"cholesky_ex + solve_triangular library call vs "
              f"chol_inv_small k={k} f64", chol_lib(g_eig[k])(),
              chol_inv_small_plain(g_eig[k])[1],
              CHOL_TOL[torch.float64]["vs_plain"])
    e1_it, e5_it = max(e1r["iters"], 1), max(e5r["iters"], 1)
    e3_steps = max(e3r["iters"] // 2, 1)  # block steps of 2 columns
    rows += [
        dict(name="stencil_spmm", source="stencil_spmv.cu",
             replaces="stencil_op.py:654", also_replaces=None,
             shape=f"{GRID} x k=4 f64, AMG-preconditioned LOBPCG (block "
                   "applies and the V-cycle's fine level; library: conv3d "
                   "on a (4, 1, ...) batch)",
             bytes=2 * n64 * EIG_NEV * 8, flops=2 * fine64.nnz * EIG_NEV,
             flops_per_ms=F64_FLOPS_PER_MS,
             kernel=lambda: stencil_spmm(fine64, xe4),
             plain=lambda: stencil_spmv_plain(fine64, xe4),
             library=lambda: conv_e4(xe4b),
             launches=e1r["launches"].get("stencil_spmm", 0),
             per_step=e1r["launches"].get("stencil_spmm", 0) / e1_it,
             err=eig_err["spmm4"]),
        dict(name="stencil_spmm", source="stencil_spmv.cu",
             replaces="stencil_op.py:654", also_replaces=None,
             shape=f"{GRID} x k=2 f64, Block Krylov-Schur (per block step)",
             bytes=2 * n64 * 2 * 8, flops=2 * fine64.nnz * 2,
             flops_per_ms=F64_FLOPS_PER_MS,
             kernel=lambda: stencil_spmm(fine64, xe2),
             plain=lambda: stencil_spmv_plain(fine64, xe2),
             library=lambda: conv_e2(xe2b),
             launches=e3r["launches"].get("stencil_spmm", 0),
             per_step=e3r["launches"].get("stencil_spmm", 0) / e3_steps,
             err=eig_err["spmm2"]),
        dict(name="stencil_spmm", source="stencil_spmv.cu",
             replaces="stencil_op.py:654", also_replaces=None,
             shape=f"{GRID} 27-point Q1 mass x k=4 f64, LOBPCG on the "
                   "pencil (K, M and the V-cycle share the count)",
             bytes=2 * n64 * EIG_NEV * 8, flops=2 * mass64.nnz * EIG_NEV,
             flops_per_ms=F64_FLOPS_PER_MS,
             kernel=lambda: stencil_spmm(mass64, xe4),
             plain=lambda: stencil_spmv_plain(mass64, xe4),
             library=lambda: conv_m4(xe4b),
             launches=e5r["launches"].get("stencil_spmm", 0),
             per_step=e5r["launches"].get("stencil_spmm", 0) / e5_it,
             err=eig_err["mass"]),
        dict(name="dia_spmm", source="dia_spmv.cu",
             replaces="dia_spmv.py:273", also_replaces="dia_spmv.py:430",
             shape=f"f64 hierarchy level 1, {a1_64.n_rows_pad} rows x "
                   f"{nd1_64} diags x k=4 f64, AMG-preconditioned LOBPCG "
                   "(all coarse levels share the count)",
             bytes=(nd1_64 + 2 * EIG_NEV) * a1_64.n_rows_pad * 8,
             flops=2 * nonzeros(a1_64) * EIG_NEV,
             flops_per_ms=F64_FLOPS_PER_MS,
             kernel=lambda: dia_spmm(a1_64, x1e),
             plain=lambda: dia_spmv_plain(a1_64, x1e),
             library=lambda: csr1_64 @ x1e,
             launches=e1r["launches"].get("dia_spmm", 0),
             per_step=e1r["launches"].get("dia_spmm", 0) / e1_it,
             err=eig_err["dia4"]),
        dict(name="chol_inv_small", source="chol_inv_small.cu",
             replaces="smalldense.py:123", also_replaces=None,
             shape="k=4 f64 (LOBPCG's CholQR2 panels)",
             bytes=3 * EIG_NEV ** 2 * 8, flops=2 * EIG_NEV ** 3 // 3,
             flops_per_ms=F64_FLOPS_PER_MS,
             kernel=lambda: chol_inv_small(g_eig[EIG_NEV]),
             plain=lambda: chol_inv_small_plain(g_eig[EIG_NEV]),
             library=chol_lib(g_eig[EIG_NEV]),
             launches=e1r["launches"].get("chol_inv_small", 0),
             per_step=e1r["launches"].get("chol_inv_small", 0) / e1_it,
             err=eig_err[f"chol{EIG_NEV}"]),
        dict(name="chol_inv_small", source="chol_inv_small.cu",
             replaces="smalldense.py:123", also_replaces=None,
             shape="k=24 f64 (Block Davidson's whitening on the mass "
                   "pencil, k 4..24; all widths share the count)",
             bytes=3 * 24 ** 2 * 8, flops=2 * 24 ** 3 // 3,
             flops_per_ms=F64_FLOPS_PER_MS,
             kernel=lambda: chol_inv_small(g_eig[24]),
             plain=lambda: chol_inv_small_plain(g_eig[24]),
             library=chol_lib(g_eig[24]),
             launches=e5d["launches"].get("chol_inv_small", 0),
             per_step=e5d["launches"].get("chol_inv_small", 0)
             / max(e5d["iters"], 1),
             err=eig_err["chol24"])]
    # fused kernels the polynomial wrappers launched on their own paths
    fused_launches = {"stencil_poly": c_fused, "stencil_powers": s_fused}
    # the empty kernel and chol_inv_small at the block path's k and at 32:
    # device time (graph replays) and host path
    empty_ms = graph_ms(lambda: smalldense.empty_launch(x0.device))
    empty_host_ms = time_ms(lambda: smalldense.empty_launch(x0.device))
    p32 = randn((4096, 32), torch.float32, seed=35)
    g32 = with_floor(p32.T @ p32)
    chol32_ms = graph_ms(lambda: chol_inv_small(g32))
    chol32_host_ms = time_ms(lambda: chol_inv_small(g32))
    log(f"empty kernel (launch floor for chol_inv_small): {empty_ms:.4f} ms "
        f"graph replay, {empty_host_ms:.4f} ms host path; chol_inv_small "
        f"k=32 f32: {chol32_ms:.4f} ms graph replay, {chol32_host_ms:.4f} "
        "ms host path")
    log(f"stencil_spmv plan {GRID} f32: "
        f"{stencil_op.spmv_plan(fine, 4, stencil_op.pointer_align(x0))}")
    kernels = []
    for r in rows:
        # ms, plain_ms, library_ms: device time, BATCH calls replayed from
        # one CUDA graph; host_path_ms: CUDA events around BATCH calls of
        # the kernel's wrapper from Python
        kernel_ms = graph_ms(r["kernel"])
        host_ms = time_ms(r["kernel"])
        plain_ms = graph_ms(r["plain"])
        library_ms = graph_ms(r["library"]) if r["library"] else None
        by_bytes = r["bytes"] / HBM_BYTES_PER_MS
        by_ops = r["flops"] / r.get("flops_per_ms", F32_FLOPS_PER_MS)
        pkg = "smalldense.py" if r["name"] == "chol_inv_small" else None
        site = ("trilinos_tpu/ops/" if pkg else "trilinos_tpu/ops/pallas/")
        entry_ = dict(
            name=r["name"], route="cuda",
            source=f"trilinos_tpu_torch/csrc/{r['source']}",
            replaces=site + r["replaces"],
            also_replaces=(site + r["also_replaces"]
                           if r["also_replaces"] else None),
            shape=r["shape"],
            launches=r["launches"], launches_per_step=r["per_step"],
            max_abs_err=r["err"],
            ms=kernel_ms, kernel_ms=kernel_ms,
            host_path_ms=host_ms, plain_ms=plain_ms,
            bound_ms=max(by_bytes, by_ops),
            bound_by="bytes" if by_bytes >= by_ops else "operations",
            library_ms=library_ms)
        entry_.update(r.get("extra", {}))
        if r["name"] in fused_launches:
            entry_["kernel_launches"] = fused_launches[r["name"]]
        if r["name"] == "chol_inv_small":
            entry_.update(empty_ms=empty_ms, empty_host_path_ms=empty_host_ms,
                          k32_ms=chol32_ms, k32_host_path_ms=chol32_host_ms)
        log(json.dumps(entry_))
        kernels.append(entry_)
    for r in dist_rows:
        # measured in rank 0 of section 7x (graph replays there too)
        by_bytes = r["bytes"] / HBM_BYTES_PER_MS
        by_ops = r["flops"] / (F64_FLOPS_PER_MS if "f64" in r["shape"]
                               else F32_FLOPS_PER_MS)
        entry_ = dict(
            name=r["name"], route="cuda",
            source=f"trilinos_tpu_torch/csrc/{r['source']}",
            replaces="trilinos_tpu/ops/pallas/" + r["replaces"],
            also_replaces=("trilinos_tpu/ops/pallas/" + r["also_replaces"]
                           if r["also_replaces"] else None),
            shape=r["shape"], launches=r["launches"],
            launches_per_rank=r["launches_per_rank"],
            launches_per_step=r["per_step"], max_abs_err=r["err"],
            ms=r["ms"], kernel_ms=r["ms"], host_path_ms=r["host_path_ms"],
            plain_ms=r["plain_ms"], bound_ms=max(by_bytes, by_ops),
            bound_by="bytes" if by_bytes >= by_ops else "operations",
            library_ms=r["library_ms"])
        log(json.dumps(entry_))
        kernels.append(entry_)
    bf16_ms = time_ms(lambda: dia_spmv(a1_bf16, x1))
    log(f"dia_spmv bf16 data at level 1: {bf16_ms:.4f} ms, bound "
        f"{(nd * 2 + 2 * 4) * n1 / HBM_BYTES_PER_MS:.4f} ms")
    bf16k_ms = time_ms(lambda: dia_spmm(a1_bf16, x1k))
    log(f"dia_spmm bf16 data at level 1, k={NRHS}: {bf16k_ms:.4f} ms, bound "
        f"{(nd * 2 + 2 * NRHS * 4) * n1 / HBM_BYTES_PER_MS:.4f} ms")
    # the DIA SpMM at k = 16 on every level of the block path
    for i, a in enumerate(levels, start=1):
        xk = randn((a.n_rows_pad, NRHS), torch.float32, seed=80 + i)
        csr_l = dia_as_csr(a)
        nd_l = len(a.offsets)
        log(f"dia SpMM level {i} ({a.n_rows_pad} rows x {nd_l} diags, "
            f"k={NRHS}, f32): kernel "
            f"{time_ms(lambda: dia_spmm(a, xk)):.4f} ms, bound "
            f"{(nd_l + 2 * NRHS) * a.n_rows_pad * 4 / HBM_BYTES_PER_MS:.4f} "
            f"ms, launches per block solve {dia_by_rows[a.n_rows_pad]}, "
            f"sparse CSR @ {time_ms(lambda: csr_l @ xk):.4f} ms")
        del xk, csr_l

    def bsr_call(a, x):
        """torch.sparse_bsr_tensor @ x, or None where the card's PyTorch
        has no such product (logged)."""
        bsr = bdia_as_bsr(a)
        try:
            y = bsr @ x[:, None]
        except (NotImplementedError, RuntimeError) as exc:
            log(f"sparse BSR @ dense not available: {exc}")
            return None
        check("sparse BSR library call vs bdia", y[:, 0],
              bdia_spmv_plain(a, x), 1e-5)
        return lambda: bsr @ x[:, None]

    # the BDIA kernel at every shape of the two elasticity paths and the
    # JAX bench's bare apply, beside its bound, plain version and library
    # calls
    bdia_shapes = [(f"elasticity {grid_e} level {i}", a, bdia_x(a, 1, 560 + i))
                   for i, a in enumerate(el_levels)]
    bdia_shapes += [
        (f"elasticity {grid_e} level 0 bf16 data", a0_bf16, xe0),
        (f"elasticity {grid_p} interleaved", a3, x3)]
    for label, a, x in bdia_shapes:
        csr = bdia_as_csr(a) if a.dtype != torch.bfloat16 else None
        bsr = bsr_call(a, x) if csr is not None else None
        log(f"bdia {label} (b={a.block_size}, nd={len(a.offsets)}, "
            f"nbr={a.nbr_pad}, k=1): kernel "
            f"{time_ms(lambda: bdia_spmv(a, x)):.4f} ms, bound "
            f"{bdia_bytes(a, 1) / HBM_BYTES_PER_MS:.4f} ms, plain "
            f"{time_ms(lambda: bdia_spmv_plain(a, x)):.4f} ms, sparse CSR @ "
            + (f"{time_ms(lambda: csr @ x):.4f} ms" if csr is not None
               else "-") + ", sparse BSR @ "
            + (f"{time_ms(bsr):.4f} ms" if bsr else "-"))
        del csr
    for k in (1, NRHS):
        x2p = bdia_x(a2, k, 570 + k, planes=True)
        log(f"bdia elasticity2d {grid2} planes (b=2, nd={len(a2.offsets)}, "
            f"nbr={a2.nbr_pad}, k={k}): kernel "
            f"{time_ms(lambda: bdia_spmm(a2, x2p, layout='planes')):.4f} ms, "
            f"bound {bdia_bytes(a2, k) / HBM_BYTES_PER_MS:.4f} ms, plain "
            f"{time_ms(lambda: bdia_planes_plain(a2, x2p)):.4f} ms")

    def unfused(stages, keep):
        """The stage chain as stencil_spmv kernel launches and plain
        axpys (256³ has no pad rows)."""
        prev2, prev, outs = zero0, x0, []
        for a, bt, g, z in stages:
            u = a * stencil_spmv(fine, prev) if a else zero0
            if bt:
                u = u + bt * prev
            if g:
                u = u + g * prev2
            if z:
                u = u + z * x0
            prev2, prev = prev, u
            if keep:
                outs.append(u)
        return outs or prev

    def unfused_cg():
        """One single-reduce iteration as a stencil_spmv launch and plain
        vector ops: the unfused sequence cg_fused replaces."""
        _, r_, w_, p_, q_, sc = cg_state
        beta, alpha = sc[0, 0] / sc[0, 2], sc[0, 3]
        p2, q2 = r_ + beta * p_, w_ + beta * q_
        r2 = r_ - alpha * q2
        w2 = stencil_spmv(fine, r2)
        return zero0 + alpha * p2, torch.stack([r2 @ r2, r2 @ w2])

    for label, fn in (("stencil_poly Chebyshev s=3", lambda: unfused(
            cheb3, False)), ("stencil_powers monomial s=4", lambda: unfused(
            mono4, True)), ("cg_fused iteration", unfused_cg)):
        log(f"unfused sequence for {label} at {GRID} f32 (stencil_spmv "
            f"kernel + plain vector ops): {time_ms(fn):.4f} ms")
    log(f"CG solve: {warm_ms:.2f} ms wall, {warm_ms / max(iters, 1):.3f} "
        f"ms/iter over {iters} iterations (first solve {solve_ms:.1f} ms; "
        f"plain versions {plain_solve_ms:.1f} ms)")
    log(f"block solve: {bwarm_ms:.2f} ms wall, "
        f"{bwarm_ms / max(steps, 1):.3f} ms/block step over {steps} block "
        f"steps of {NRHS} right-hand sides (first solve {bsolve_ms:.1f} ms; "
        f"plain versions {bplain_ms:.1f} ms); launches per block step "
        f"{b_per}; peak memory {bpeak:.2f} GiB (plain {bplain_peak:.2f} GiB)")
    log(f"Chebyshev AMG-PCG solve: {cwarm_ms:.2f} ms wall, "
        f"{cwarm_ms / max(citers, 1):.3f} ms/iter over {citers} iterations "
        f"(first solve {csolve_ms:.1f} ms; plain versions {cplain_ms:.1f} "
        f"ms); launches per iteration {c_per}")
    log(f"s-step GMRES solve: {swarm_ms:.2f} ms wall, "
        f"{swarm_ms / sres.iters:.3f} ms per basis vector over {sres.iters} "
        f"(first solve {ssolve_ms:.1f} ms; plain versions {splain_ms:.1f} "
        f"ms); launches per block of 4 {s_per}")
    log(f"elasticity {grid_e} AMG-PCG: set-up {el_setup_s:.2f} "
        f"s; solve {ewarm_ms:.2f} ms wall, {ewarm_ms / max(eiters, 1):.3f} "
        f"ms/iter over {eiters} iterations (first solve {esolve_ms:.1f} ms; "
        f"plain versions {eplain_ms:.1f} ms); launches per iteration "
        f"{e_per}, per solve {e_launches}")
    log(f"plane-layout CG {grid_p}: {pwarm_ms:.2f} ms wall, "
        f"{pwarm_ms / PLANE_ITERS:.4f} ms/iter over {PLANE_ITERS} iterations "
        f"(first solve {psolve_ms:.1f} ms); launches {p_launches}")
    log(f"hierarchy set-ups (native SpGEMM): {GRID} Jacobi "
        f"{jacobi_setup_s:.2f} s, Chebyshev {cheb_setup_s:.2f} s, "
        f"elasticity {grid_e} {el_setup_s:.2f} s")
    log(f"fused CG solve: {fwarm_ms:.2f} ms wall, "
        f"{fwarm_ms / max(fres.iters, 1):.4f} ms/iter over {fres.iters} "
        f"iterations (first solve {fsolve_ms:.1f} ms); launches per "
        f"iteration {f_per}")

    for label, run in gmres_runs.items():
        log(f"GMRES(30) {GRID} {label} solve: {run['warm']:.2f} ms wall, "
            f"{run['warm'] / GMRES_ITERS:.3f} ms/iter over {GMRES_ITERS} "
            f"iterations (first solve {run['first']:.1f} ms; plain versions "
            f"{run['plain']:.1f} ms); launches per iteration {run['per']}; "
            f"the solve's own peak memory {run['peak']:.2f} GiB")
    log(f"AMG-GMRES(30) solve: {awarm_ms:.2f} ms wall, "
        f"{awarm_ms / max(aiters, 1):.3f} ms/iter over {aiters} iterations "
        f"(first solve {asolve_ms:.1f} ms; plain versions {aplain_ms:.1f} "
        f"ms); launches per iteration {a_per}")
    log(f"BASELINE config 2 solve ({grid2c}, nrhs {c2b.shape[1]}, f64): "
        f"{c2warm_ms:.2f} ms wall, {c2warm_ms / max(c2res.iters, 1):.4f} "
        f"ms/iter over {c2res.iters} iterations (first solve "
        f"{c2solve_ms:.1f} ms); column 0 variants " + ", ".join(
            f"{k} {it} iters {ms:.1f} ms" for k, (it, ms, _) in
            c2_variants.items()))

    for name, run in fk_runs.items():
        log(f"factory {name!r} solve: {run['warm']:.2f} ms wall, "
            f"{run['warm'] / max(run['iters'], 1):.3f} ms/iter over "
            f"{run['iters']} iterations (first solve {run['first']:.1f} ms); "
            f"launches {run['launches']}")
    for name, run in block_runs.items():
        log(f"factory {name!r} solve: {run['warm']:.2f} ms wall, "
            f"{run['warm'] / max(run['iters'], 1):.3f} ms/iter over "
            f"{run['iters']} iterations (first solve {run['first']:.1f} ms"
            + (f"; plain versions {run['plain']:.1f} ms" if "plain" in run
               else "") + f"); launches {run['launches']}")
    log(f"BASELINE config 4 solve ({grid4}, f64): {c4warm_ms:.2f} ms wall, "
        f"{c4warm_ms / max(c4iters, 1):.4f} ms/iter over {c4iters} "
        f"iterations (first solve {c4ms:.1f} ms; plain versions "
        f"{c4plain_ms:.1f} ms); launches {c4launch}")
    log(f"build() CG + CHEBYSHEV solve ({GRID}, f32): {chwarm_ms:.2f} ms "
        f"wall, {chwarm_ms / max(chiters, 1):.3f} ms/iter over {chiters} "
        f"iterations (first solve {chms:.1f} ms; plain versions "
        f"{chplain_ms:.1f} ms); launches {chlaunch}")
    for prec, run in poly_runs.items():
        log(f"build() GMRES(30) + {prec} solve ({GRID}, f32, {POLY_ITERS} "
            f"iterations): {run['warm']:.2f} ms wall, "
            f"{run['warm'] / POLY_ITERS:.3f} ms/iter (first solve "
            f"{run['first']:.1f} ms); launches {run['launches']}; true "
            f"relative residual {run['true']:.3e}")

    log(f"BASELINE config 3 solve (recirc2d {grid3}, nrhs 2, f64): "
        f"{c3warm_ms:.2f} ms wall, {c3warm_ms / max(c3steps, 1):.3f} ms per "
        f"block step over {c3steps} block steps (first solve {c3ms:.1f} ms; "
        f"plain versions {c3plain_ms:.1f} ms); set-up (write, read, ELL, "
        f"ILU) {c3_setup_s:.2f} s; launches {c3launch}")
    log(f"uncoupled AMG-PCG {gridu} f32: host set-up {u_setup_s:.2f} s; "
        f"solve {uwarm_ms:.2f} ms wall, {uwarm_ms / max(uiters, 1):.3f} "
        f"ms/iter over {uiters} iterations (first solve {usolve_ms:.1f} ms; "
        f"plain versions {uplain_ms:.1f} ms); launches per iteration "
        f"{u_per}, per solve {u_launches}")
    log(f"null-space uncoupled SA-AMG PCG {grid_e} f32: host set-up "
        f"{ns_setup_s:.2f} s; solve {nswarm_ms:.2f} ms wall over {nsiters} "
        f"iterations (first solve {nsms:.1f} ms); launches per iteration "
        f"{ns_per}; BlockStructuredAmg: {eiters} iterations, "
        f"{ewarm_ms:.2f} ms, set-up {el_setup_s:.2f} s")
    for label, run in build_runs.items():
        log(f"build() GMRES(30) + {label}: {run['iters']} iterations (JAX "
            f"package, CPU f64: {run['cpu']}), set-up {run['setup']:.2f} s, "
            f"first solve {run['first']:.1f} ms, launches {run['launches']}")
    for label, run in direct_host.items():
        log(f"{label} on {run['matrix']}: factor {run['factor_s']:.3f} s, "
            f"{DIRECT_HOST_RHS} solves {run['solve_s']:.3f} s, nnz_factors "
            f"{run['nnz']}")
    for name, run in direct_runs.items():
        log(f"build() + {name} ({DIRECT_NX}x{DIRECT_NX}, f64): set-up "
            f"{run['setup']:.2f} s, {run['iters']} iterations, first solve "
            f"{run['first']:.1f} ms, inverse GEMV {run['gemv']:.4f} ms "
            f"(bound {run['bound']:.4f} ms)")
    log(f"two-level Schwarz CG laplace2d {grid_tl} f64: set-up "
        f"{tl_setup_s:.2f} s; solve {tlwarm_ms:.2f} ms wall, "
        f"{tlwarm_ms / max(tl_runs['two-level']['iters'], 1):.3f} ms/iter "
        f"over {tl_runs['two-level']['iters']} iterations (one-level: "
        f"{tl_runs['one-level']['iters']} iterations, first solve "
        f"{tl_runs['one-level']['first']:.1f} ms)")
    log(f"Komplex {grid_k} (GMRES(30) + RILUK on the real form, set-up "
        f"included): {kwarm_ms:.2f} ms wall over {kres_iters} iterations "
        f"(first solve {kms:.1f} ms); dense_solve {DENSE_N}² f64 "
        f"{dense_ms:.2f} ms")

    for key, run in eig_runs.items():
        it = run["iters"]
        per = f", {run['warm'] / it:.3f} ms/iter over {it} iterations" \
            if it else ""
        log(f"{run['label']}: warm {run['warm']:.2f} ms{per} (first "
            f"{run['first']:.1f} ms; plain versions {run['plain']:.1f} ms); "
            f"peak device memory {run['peak']:.2f} GiB; launches "
            f"{run['launches']}")

    at("9")
    # -- 9. one solve of each path under the profiler: device time by kernel
    # (last, so that it cannot disturb the timings above)
    profile("CG solve", lambda: step(b, state), focus="stencil_kernel")
    profile("block solve", lambda: bstep(bb, bstate))
    profile("Chebyshev AMG-PCG solve", lambda: cstep(cb, cstate),
            focus="stencil_kernel")
    profile("s-step GMRES solve", lambda: sstep(sb))
    profile("fused CG solve", lambda: fstep(fb))
    profile("elasticity AMG-PCG solve", lambda: estep(eb, est))
    profile("plane-layout CG solve", lambda: pstep(pb))
    for label, run in gmres_runs.items():
        profile(f"GMRES(30) {label} solve", lambda: run["step"](*run["args"]),
                focus="stencil_kernel")
    profile("AMG-GMRES(30) solve", lambda: astep(ab, ast),
            focus="stencil_kernel")
    profile("BASELINE config 2 solve", lambda: c2step(c2b))
    profile("BASELINE config 4 (pipelined CG) solve", lambda: c4step(c4b),
            focus="dia_kernel")
    bcg = block_runs["Block CG"]
    profile("factory Block CG solve", lambda: bcg["step"](*bcg["args"]))
    gc = fk_runs["GCRODR"]
    profile("factory GCRODR solve (recycled space)",
            lambda: gc["step"](*gc["args"]))

    profile("BASELINE config 3 (ILU + DGKS block GMRES) solve",
            lambda: c3step(c3b), focus="dia_mv_kernel")
    profile(f"uncoupled AMG-PCG {gridu} solve", lambda: ustep(ub, ust),
            focus="dia_kernel")
    profile(f"null-space uncoupled AMG-PCG {grid_e} solve",
            lambda: ns_step(eb, nsst), focus="dia_kernel")
    profile(f"two-level Schwarz CG {grid_tl} solve",
            lambda: tl_step(tlm)(tlb), focus="dia_kernel")
    profile(f"Komplex {grid_k} solve (set-up included)", lambda: kstep(kbz),
            focus="dia_kernel")

    for key in ("e1", "e2", "e3", "e5 LOBPCG"):
        run = eig_runs[key]
        profile(run["label"], lambda: run["step"](*run["args"]),
                focus="stencil_mv_kernel")

    log(f"chip_smoke total: {time.perf_counter() - t_main:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
