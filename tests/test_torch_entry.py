"""The port's main path as a whole: the twin of ``__graft_entry__.entry()``.

Structured-AMG-preconditioned CG on Laplace3D 16³: in f64 the port must
take the same number of CG iterations as the JAX package and reach the
same solution to 1e-9 (max|Δ| / max|x|); in f32, within one iteration and
1e-4. The elasticity paths at 8³ (block-AMG PCG, plane-layout CG) in f64:
the JAX bench's solves, the same iteration count and x to 1e-10. Also: the
port imports neither JAX nor the JAX package, entry points refuse to run
without a card unless asked for the CPU, the kernel launch counters stay 0
on the CPU, and float32 matmuls stay in full precision. The JAX package's
elasticity matrix is assembled once for the tests of one process, and the
port runs on one intra-op thread (the suite runs a process a core; these
small tensors gain nothing from more threads and lose much to
oversubscription).
"""
import ast
import functools
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trilinos_tpu.galeri import fem as jfem
from trilinos_tpu.galeri import laplace3d as j_laplace3d
from trilinos_tpu.ops import csr_to_bdia as j_csr_to_bdia
from trilinos_tpu.ops import spmv as j_spmv
from trilinos_tpu.ops.pallas.bdia_spmv import (
    bdia_plane_solver_op as j_bdia_plane_solver_op)
from trilinos_tpu.precond import SaAmg as JSaAmg
from trilinos_tpu.precond.block_amg import BlockStructuredAmg as JBlockAmg
from trilinos_tpu.solvers import cg as j_cg

import trilinos_tpu_torch
from trilinos_tpu_torch.entry import (bdia_cg_entry, block_entry,
                                      bratu_entry, bsr_gmres_entry,
                                      cheb_entry,
                                      dist_amg_entry, dist_eigen_entry,
                                      dist_md_entry,
                                      dist_pipelined_cg_entry,
                                      dist_schwarz_entry, dist_sstep_entry,
                                      eigen_entry, elasticity_entry, entry,
                                      fused_cg_entry, gmres_entry,
                                      komplex_entry, mm_block_gmres_entry,
                                      nonlinear_pde_entry, phalanx_amg,
                                      phalanx_entry, sstep_entry,
                                      uncoupled_amg_entry)
from trilinos_tpu_torch.galeri import (elasticity3d, laplace3d,
                                       rigid_body_modes)
from trilinos_tpu_torch.ops import (bdia_spmm, bdia_spmv, cg_fused_iteration,
                                    dia_spmv, spgemm, spmv,
                                    stencil_poly_apply, stencil_powers_apply,
                                    stencil_spmv)
from trilinos_tpu_torch.parallel import SerialComm
from trilinos_tpu_torch.precond import BlockStructuredAmg, SaAmg
from torch_threads import one_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent


@functools.lru_cache(maxsize=None)
def j_elasticity(dims):
    """The JAX package's Galeri elasticity3d (E = 1) on ``dims`` nodes."""
    return jfem.elasticity3d(*dims, e_mod=1.0)


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def jax_entry(dtype):
    """The body of ``__graft_entry__.entry()`` with its dtype as a
    parameter, returning the whole SolveResult."""
    op = j_laplace3d(16, 16, 16, dtype=dtype, fmt="stencil")
    m = JSaAmg(op, {"dtype": dtype}).compute()
    n, npad = op.n_rows, op.n_rows_pad
    b = np.zeros(npad, dtype)
    b[:n] = np.random.default_rng(0).standard_normal(n)
    st = m.state()
    return b, j_cg(lambda v: j_spmv(op, v), jnp.asarray(b),
                   prec=lambda v: m.apply_state(st, v), rtol=1e-5,
                   maxiter=50)


@pytest.mark.parametrize("dtype,max_diters,tol", [
    (np.float64, 0, 1e-9), (np.float32, 1, 1e-4)])
def test_entry_twin_matches_jax(dtype, max_diters, tol):
    stencil_spmv.launches = dia_spmv.launches = 0
    step, (b, state) = entry(dtype=dtype, device="cpu")
    res = step(b, state)
    jb, jres = jax_entry(dtype)
    np.testing.assert_array_equal(b.numpy(), jb)
    assert bool(res.converged) and bool(jres.converged)
    assert abs(res.iters - int(jres.iters)) <= max_diters
    assert rel(res.x.numpy(), jres.x) <= tol
    assert res.x.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
    # on the CPU every wrapper ran its plain version: no kernel launched
    assert stencil_spmv.launches == 0 and dia_spmv.launches == 0


def test_new_paths_launch_no_kernel_on_the_cpu():
    """The s-step and fused-CG paths at 16³ on the CPU: every wrapper runs
    its plain version, so the kernels' counters stay 0, the kernel counts of
    the polynomial wrappers too."""
    counters = (stencil_poly_apply, stencil_powers_apply, cg_fused_iteration,
                stencil_spmv)
    for fn in counters:
        fn.launches = 0
    stencil_poly_apply.kernel_launches = 0
    stencil_powers_apply.kernel_launches = 0
    step, (b,) = sstep_entry(device="cpu")
    assert step(b).iters == 160
    step, (b,) = fused_cg_entry(device="cpu")
    assert bool(step(b).converged)
    assert [fn.launches for fn in counters] == [0, 0, 0, 0]
    assert stencil_poly_apply.kernel_launches == 0
    assert stencil_powers_apply.kernel_launches == 0


def test_gmres_entry_matches_jax_and_runs_on_the_cpu():
    """gmres_entry at 16³: unpreconditioned GMRES(30) with CGS2 at rtol 0
    (the fixed-work form) against the JAX package's gmres on its StencilOp,
    f64: the same iterations and x; then AMG-preconditioned and with a bf16
    basis, where no kernel launches on the CPU."""
    from trilinos_tpu.solvers import gmres as j_gmres

    step, (b, st) = gmres_entry(dtype=np.float64, device="cpu", rtol=0.0,
                                maxiter=40)
    assert st is None
    res = step(b, st)
    op = j_laplace3d(16, 16, 16, dtype=np.float64, fmt="stencil")
    jres = j_gmres(lambda v: j_spmv(op, v), jnp.asarray(b.numpy()),
                   restart=30, rtol=0.0, maxiter=40, ortho="CGS2")
    assert res.iters == int(jres.iters) == 60  # two whole cycles
    assert rel(res.x.numpy(), jres.x) <= 1e-9
    stencil_spmv.launches = dia_spmv.launches = 0
    amg = SaAmg(laplace3d(16, 16, 16, dtype=np.float32, fmt="stencil"),
                {"dtype": np.float32}, device="cpu").compute()
    m_step, (mb, mst) = gmres_entry(amg=amg)
    mres = m_step(mb, mst)
    assert bool(mres.converged) and mres.iters < 30
    fine = laplace3d(16, 16, 16, dtype=np.float64, fmt="stencil")
    r = mb.double() - spmv(fine, mres.x.double())
    assert float(r.norm() / mb.double().norm()) <= 1e-5
    b_step, b_args = gmres_entry(device="cpu", basis_dtype=torch.bfloat16,
                                 rtol=0.0, maxiter=30)
    bres = b_step(*b_args)
    assert bres.iters == 30 and bool(torch.isfinite(bres.x).all())
    assert stencil_spmv.launches == 0 and dia_spmv.launches == 0


def test_mm_block_gmres_entry_matches_jax(tmp_path):
    """BASELINE config 3's twin at 32²: recirc2d written and read back as
    Matrix Market, ELL, Ilu0 with 20 sweeps, DGKS block GMRES on 2 seed-2
    normals, f64, against the JAX package's pipeline on the same file: the
    same 29 block steps and x to 1e-8, through the native reader and the
    native ILU(0), with no kernel launched on the CPU."""
    from trilinos_tpu import precond as jprec
    from trilinos_tpu.io import read_sparse as j_read_sparse
    from trilinos_tpu.ops import csr_to_ell as j_csr_to_ell
    from trilinos_tpu.solvers import block_gmres as j_block_gmres
    from trilinos_tpu_torch.io import matrix_market
    from trilinos_tpu_torch.precond import ilu

    path = tmp_path / "recirc2d_32.mtx"
    before = (matrix_market.read_sparse.native_calls,
              ilu.ilu0_factor.native_calls)
    dia_spmv.launches = 0
    step, (b,) = mm_block_gmres_entry(32, device="cpu", path=path)
    assert (matrix_market.read_sparse.native_calls,
            ilu.ilu0_factor.native_calls) == (before[0] + 1, before[1] + 1)
    assert isinstance(step.preconditioner._l, type(
        step.preconditioner._u)) and hasattr(step.preconditioner._l,
                                             "offsets")
    res = step(b)
    a = j_read_sparse(str(path))
    np.testing.assert_array_equal(step.matrix.vals, a.vals)
    dev = j_csr_to_ell(a)
    jm = jprec.Ilu0(a, {"fact: sweeps": 20}).compute()
    jres = j_block_gmres(lambda x: j_spmv(dev, x, impl="xla"),
                         jnp.asarray(b.numpy()), prec=jm, num_blocks=60,
                         max_restarts=20, rtol=1e-8, ortho="DGKS")
    assert res.iters == int(jres.iters) == 29
    assert bool(res.converged.all())
    assert rel(res.x.numpy(), jres.x) <= 1e-8
    n = a.shape[0]
    r = b.numpy()[:n] - a.to_dense() @ res.x.numpy()[:n]
    assert (np.linalg.norm(r, axis=0)
            / np.linalg.norm(b.numpy()[:n], axis=0)).max() <= 1e-6
    assert dia_spmv.launches == 0


@pytest.mark.parametrize("kind", ["mtx", "hb"])
def test_mm_block_gmres_entry_reads_a_given_file(tmp_path, kind):
    """Config 3 on a given file, Matrix Market or Harwell-Boeing (recirc2d
    24² written by the test): the block steps and x of the JAX package's
    pipeline on the same file, the file's bytes and mtime unchanged, and
    no file written beside it."""
    import os

    from test_torch_io import write_hb
    from trilinos_tpu import precond as jprec
    from trilinos_tpu.galeri import recirc2d as j_recirc2d
    from trilinos_tpu.io import read_hb as j_read_hb
    from trilinos_tpu.io import read_sparse as j_read_sparse
    from trilinos_tpu.io import write_sparse as j_write_sparse
    from trilinos_tpu.ops import csr_to_ell as j_csr_to_ell
    from trilinos_tpu.solvers import block_gmres as j_block_gmres

    path = tmp_path / f"given.{kind}"
    if kind == "mtx":
        j_write_sparse(str(path), j_recirc2d(24, 24))
    else:
        write_hb(path, j_recirc2d(24, 24), "RUA")
    os.utime(path, (1_000_000_000, 1_000_000_000))
    data, mtime = path.read_bytes(), path.stat().st_mtime_ns
    step, (b,) = mm_block_gmres_entry(device="cpu", matrix_file=path)
    res = step(b)
    assert path.read_bytes() == data and path.stat().st_mtime_ns == mtime
    assert sorted(p.name for p in tmp_path.iterdir()) == [path.name]
    a = (j_read_sparse if kind == "mtx" else j_read_hb)(str(path))
    np.testing.assert_array_equal(step.matrix.vals, a.vals)
    jm = jprec.Ilu0(a, {"fact: sweeps": 20}).compute()
    dev = j_csr_to_ell(a)
    jres = j_block_gmres(lambda x: j_spmv(dev, x, impl="xla"),
                         jnp.asarray(b.numpy()), prec=jm, num_blocks=60,
                         max_restarts=20, rtol=1e-8, ortho="DGKS")
    assert res.iters == int(jres.iters) and bool(res.converged.all())
    assert rel(res.x.numpy(), jres.x) <= 1e-8
    with pytest.raises(ValueError, match="not both"):
        mm_block_gmres_entry(device="cpu", path=tmp_path / "x.mtx",
                             matrix_file=path)


@pytest.mark.parametrize("dtype,max_diters,tol", [
    (np.float64, 0, 1e-9), (np.float32, 0, 1e-4)])
def test_uncoupled_amg_entry_matches_jax(dtype, max_diters, tol):
    """Uncoupled SA-AMG PCG on the stored Laplace3D 16³ against the JAX
    package's hierarchy on the same CSR: the same CG iterations and x
    (f64 to 1e-9, f32 to 1e-4); the fine level is DIA, the coarse ELL."""
    step, (b, st) = uncoupled_amg_entry(dtype=dtype, device="cpu")
    res = step(b, st)
    jm = JSaAmg(j_laplace3d(16, 16, 16, dtype=dtype),
                {"dtype": dtype, "aggregation: type": "uncoupled"}).compute()
    jst = jm.state()
    jfine = jst["levels"][0]["a"]
    jres = j_cg(lambda v: j_spmv(jfine, v), jnp.asarray(b.numpy()),
                prec=lambda v: jm.apply_state(jst, v), rtol=1e-5, maxiter=50)
    assert bool(res.converged) and bool(jres.converged)
    assert abs(res.iters - int(jres.iters)) <= max_diters
    assert rel(res.x.numpy(), jres.x) <= tol
    assert res.x.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
    assert [type(lv["a"]).__name__ for lv in st["levels"]][:2] == [
        "DiaMatrix", "EllMatrix"]


def test_bsr_gmres_entry_runs_on_the_cpu():
    """BASELINE config 2 at 8³: BSR b = 4, Relaxation, GMRES(30), nrhs 4,
    f64; every column's true residual ≤ 1e-7 (the JAX twin is in
    tests/test_torch_gmres.py)."""
    step, (b,) = bsr_gmres_entry(dims=(8, 8, 8), device="cpu")
    assert b.shape == (512, 4) and b.dtype == torch.float64
    res = step(b)
    assert bool(res.converged.all())
    dense = torch.from_numpy(laplace3d(8, 8, 8).to_dense())
    true = (b - dense @ res.x).norm(dim=0) / b.norm(dim=0)
    assert bool((true <= 1e-7).all())


def jax_elasticity_rhs(a, npad):
    b = np.zeros(npad)
    b[:a.shape[0]] = np.random.default_rng(0).standard_normal(a.shape[0])
    return b


@pytest.mark.parametrize("coarse_max", [3000, 512])
def test_elasticity_entry_matches_jax(coarse_max):
    """``bench_elasticity_amg``'s solve at 8³ in f64. With the entry's
    "coarse: max size" 3000 the 1536 dofs are the coarsest level (no
    BDIA level); 512 gives one BDIA level with b = 3 → k = 6."""
    dims = (8, 8, 8)
    params = {"dtype": np.float64, "coarse: max size": coarse_max}
    amg = None
    calls = (spgemm.native_calls, spgemm.numpy_calls)
    if coarse_max != 3000:
        amg = BlockStructuredAmg(
            elasticity3d(*dims, e_mod=1.0), params, node_dims=dims,
            nullspace=rigid_body_modes(*dims), n_equations=3,
            device="cpu").compute()
        # the level's smoothed P (two products) and PᵀAP (two), natively
        assert (spgemm.native_calls - calls[0],
                spgemm.numpy_calls - calls[1]) == (4, 0)
    bdia_spmv.launches = 0
    step, (b, state) = elasticity_entry(dims, np.float64, device="cpu",
                                        amg=amg)
    res = step(b, state)
    ja = j_elasticity(dims)
    jm = JBlockAmg(ja, params, node_dims=dims,
                   nullspace=jfem.rigid_body_modes(*dims),
                   n_equations=3).compute()
    assert len(jm.levels) == (0 if amg is None else 1)
    dev = jm.levels[0]["a"] if jm.levels else j_csr_to_bdia(ja, 3)
    jb = jax_elasticity_rhs(ja, dev.n_rows_pad)
    np.testing.assert_array_equal(b.numpy(), jb)
    jres = j_cg(lambda v: j_spmv(dev, v), jnp.asarray(jb), prec=jm,
                rtol=1e-5, maxiter=100)
    assert bool(res.converged) and bool(jres.converged)
    assert res.iters == int(jres.iters)
    assert rel(res.x.numpy(), jres.x) <= 1e-10
    assert bdia_spmv.launches == 0


def test_bdia_cg_entry_matches_jax():
    """``bench_bdia_solve``'s plane-layout CG at 8³ in f64, 400 iterations
    at rtol 0."""
    bdia_spmm.launches = 0
    step, (b,) = bdia_cg_entry((8, 8, 8), dtype=np.float64, device="cpu")
    res = step(b)
    ja = j_csr_to_bdia(j_elasticity((8, 8, 8)), 3)
    op, pack, unpack = j_bdia_plane_solver_op(ja)
    jb = jax_elasticity_rhs(ja, ja.n_rows_pad)
    np.testing.assert_array_equal(b.numpy(), jb)
    jres = j_cg(op, pack(jnp.asarray(jb)), rtol=0.0, maxiter=400)
    assert res.iters == int(jres.iters) == 400
    assert res.x.shape == b.shape
    assert rel(res.x.numpy(), unpack(jres.x)) <= 1e-10
    assert bdia_spmm.launches == 0


def test_entry_inputs_match_graft_entry():
    from __graft_entry__ import entry as graft_entry

    _, (jb, jst) = graft_entry()
    _, (b, st) = entry(device="cpu")
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    assert len(st["levels"]) == len(jst["levels"])
    assert st["coarse_inv"].shape == tuple(jst["coarse_inv"].shape)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((ROOT / "trilinos_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    # the distributed tests' rank processes start in this module
    files.append(ROOT / "tests" / "torch_dist_tasks.py")
    assert len(files) > 20
    names = {f.relative_to(ROOT).as_posix() for f in files}
    assert {"trilinos_tpu_torch/ops/smalldense.py",
            "trilinos_tpu_torch/solvers/ortho.py",
            "trilinos_tpu_torch/solvers/block_gmres.py",
            "trilinos_tpu_torch/ops/stencil_poly.py",
            "trilinos_tpu_torch/ops/cg_fused.py",
            "trilinos_tpu_torch/precond/chebyshev.py",
            "trilinos_tpu_torch/eigen/lanczos.py",
            "trilinos_tpu_torch/eigen/lobpcg.py",
            "trilinos_tpu_torch/eigen/krylov_schur.py",
            "trilinos_tpu_torch/eigen/davidson.py",
            "trilinos_tpu_torch/eigen/gen_davidson.py",
            "trilinos_tpu_torch/eigen/tracemin.py",
            "trilinos_tpu_torch/eigen/rtr.py",
            "trilinos_tpu_torch/eigen/spectral.py",
            "trilinos_tpu_torch/eigen/factory.py",
            "trilinos_tpu_torch/solvers/sstep_gmres.py",
            "trilinos_tpu_torch/ops/bdia_spmv.py",
            "trilinos_tpu_torch/ops/fe.py",
            "trilinos_tpu_torch/galeri/fem.py",
            "trilinos_tpu_torch/precond/block_amg.py",
            "trilinos_tpu_torch/native/__init__.py",
            "trilinos_tpu_torch/ops/compensated.py",
            "trilinos_tpu_torch/precond/jacobi.py",
            "trilinos_tpu_torch/solvers/gmres.py",
            "trilinos_tpu_torch/solvers/gmres_ca.py",
            "trilinos_tpu_torch/solvers/status.py",
            "trilinos_tpu_torch/solvers/linear_problem.py",
            "trilinos_tpu_torch/solvers/bicgstab.py",
            "trilinos_tpu_torch/solvers/tfqmr.py",
            "trilinos_tpu_torch/solvers/minres.py",
            "trilinos_tpu_torch/solvers/lsqr.py",
            "trilinos_tpu_torch/solvers/block_cg.py",
            "trilinos_tpu_torch/solvers/rcg.py",
            "trilinos_tpu_torch/solvers/gcrodr.py",
            "trilinos_tpu_torch/solvers/block_gcrodr.py",
            "trilinos_tpu_torch/solvers/factory.py",
            "trilinos_tpu_torch/precond/poly.py",
            "trilinos_tpu_torch/utils/output.py",
            "trilinos_tpu_torch/io/matrix_market.py",
            "trilinos_tpu_torch/io/harwell_boeing.py",
            "trilinos_tpu_torch/io/container.py",
            "trilinos_tpu_torch/precond/ilu.py",
            "trilinos_tpu_torch/precond/ilut.py",
            "trilinos_tpu_torch/precond/containers.py",
            "trilinos_tpu_torch/precond/multicolor_gs.py",
            "trilinos_tpu_torch/precond/schwarz.py",
            "trilinos_tpu_torch/precond/hiptmair.py",
            "trilinos_tpu_torch/solvers/direct.py",
            "trilinos_tpu_torch/solvers/pliris.py",
            "trilinos_tpu_torch/precond/direct_prec.py",
            "trilinos_tpu_torch/precond/two_level_schwarz.py",
            "trilinos_tpu_torch/precond/block_2x2.py",
            "trilinos_tpu_torch/ops/komplex.py",
            "trilinos_tpu_torch/ops/filters.py",
            "trilinos_tpu_torch/parallel/partition.py",
            "trilinos_tpu_torch/parallel/map.py",
            "trilinos_tpu_torch/parallel/comm.py",
            "trilinos_tpu_torch/parallel/distmatrix.py",
            "trilinos_tpu_torch/parallel/dist_setup.py",
            "trilinos_tpu_torch/parallel/driver.py",
            "trilinos_tpu_torch/parallel/solve_kinds.py",
            "trilinos_tpu_torch/fem/__init__.py",
            "trilinos_tpu_torch/fem/cells.py",
            "trilinos_tpu_torch/fem/basis.py",
            "trilinos_tpu_torch/fem/cubature.py",
            "trilinos_tpu_torch/fem/cell_tools.py",
            "trilinos_tpu_torch/fem/mesh.py",
            "trilinos_tpu_torch/fem/assembly.py",
            "trilinos_tpu_torch/fem/refine.py",
            "trilinos_tpu_torch/fem/mortar.py",
            "trilinos_tpu_torch/io/vtk.py",
            "trilinos_tpu_torch/ops/autodiff.py",
            "trilinos_tpu_torch/nonlinear/__init__.py",
            "trilinos_tpu_torch/nonlinear/base.py",
            "trilinos_tpu_torch/nonlinear/newton.py",
            "trilinos_tpu_torch/nonlinear/trust_region.py",
            "trilinos_tpu_torch/nonlinear/anderson.py",
            "trilinos_tpu_torch/nonlinear/continuation.py",
            "trilinos_tpu_torch/nonlinear/integrators.py",
            "trilinos_tpu_torch/fem/phalanx.py",
            "trilinos_tpu_torch/piro.py",
            "trilinos_tpu_torch/optim/__init__.py",
            "trilinos_tpu_torch/optim/base.py",
            "trilinos_tpu_torch/optim/bounds.py",
            "trilinos_tpu_torch/optim/lbfgs.py",
            "trilinos_tpu_torch/optim/trust_region.py",
            "trilinos_tpu_torch/optim/auglag.py",
            "tests/torch_dist_tasks.py"} <= names
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "trilinos_tpu"), (f, mod)


def test_port_test_modules_hold_one_thread():
    """Every port test module imports the autouse ``one_thread`` fixture
    as a module-level statement (one in a docstring never runs)."""
    files = sorted((ROOT / "tests").glob("test_torch_*.py"))
    assert len(files) > 40
    for f in files:
        tree = ast.parse(f.read_text(), filename=str(f))
        assert any(isinstance(node, ast.ImportFrom)
                   and node.module == "torch_threads"
                   and [a.name for a in node.names] == ["one_thread"]
                   for node in tree.body), f


def test_dist_entries_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for fn in (dist_sstep_entry, dist_eigen_entry, dist_schwarz_entry,
               dist_md_entry):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(comm=SerialComm())


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()
    for fn in (block_entry, cheb_entry, sstep_entry, fused_cg_entry,
               elasticity_entry, bdia_cg_entry, gmres_entry,
               bsr_gmres_entry, mm_block_gmres_entry, uncoupled_amg_entry,
               komplex_entry, lambda: eigen_entry("LOBPCG"), bratu_entry,
               nonlinear_pde_entry, phalanx_entry, phalanx_amg,
               lambda: dist_pipelined_cg_entry(comm=SerialComm()),
               lambda: dist_amg_entry(comm=SerialComm())):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()
    from trilinos_tpu_torch.galeri import laplace3d
    from trilinos_tpu_torch.precond import SaAmg

    with pytest.raises(RuntimeError, match="no CUDA device"):
        SaAmg(laplace3d(8, 8, 8, fmt="stencil"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        laplace3d(8, 8, 8, fmt="dia")


def test_float32_matmul_precision_is_highest():
    assert trilinos_tpu_torch.__name__ == "trilinos_tpu_torch"
    assert torch.get_float32_matmul_precision() == "highest"
    assert torch.backends.cuda.matmul.allow_tf32 is False


# -- the application layer: bratu_entry, nonlinear_pde_entry, phalanx_entry --

BRATU_DIMS = (12, 12, 12)


@functools.lru_cache(maxsize=None)
def jax_bratu(dims=BRATU_DIMS, lam=4.0):
    """The JAX composition bratu_entry twins: newton_krylov (type2
    forcing, polynomial line search) on F(u) = A u − λh²·mask·e^u with A
    the Laplace3D StencilOp through spmv(impl="xla"), right-preconditioned
    by the structured SaAmg's V-cycle, f64."""
    from trilinos_tpu.nonlinear import newton_krylov as j_newton

    op = j_laplace3d(*dims, dtype=np.float64, fmt="stencil")
    m = JSaAmg(op, {"dtype": np.float64}).compute()
    st = m.state()
    mask = np.zeros(op.n_rows_pad)
    mask[:op.n_rows] = 1.0
    scale = jnp.asarray(lam / (dims[0] + 1) ** 2 * mask)
    res = j_newton(lambda u: j_spmv(op, u, impl="xla") - scale * jnp.exp(u),
                   jnp.zeros(op.n_rows_pad),
                   prec_factory=lambda x: (lambda v: m.apply_state(st, v)),
                   rtol=1e-10, forcing="type2", linesearch="polynomial")
    return res


def test_bratu_entry_matches_jax():
    """JFNK 3-D Bratu at 12³, f64: the JAX composition's Newton and GMRES
    iterations, x to 1e-10 (max |Δ|); the residual's stencil applies and
    Jacobian actions ran the plain versions (no launch on the CPU)."""
    from trilinos_tpu_torch.ops.autodiff import LinearApply

    stencil_spmv.launches = dia_spmv.launches = 0
    jvps = LinearApply.jvp_calls
    step, (u0, st) = bratu_entry(BRATU_DIMS, dtype=np.float64, device="cpu",
                                 rtol=1e-10)
    res = step(u0, st)
    jres = jax_bratu()
    assert res.converged and bool(jres.converged)
    assert res.iters == int(jres.iters)
    assert res.inner_iters == int(jres.inner_iters)
    assert np.abs(res.x.numpy() - np.asarray(jres.x)).max() <= 1e-10
    assert LinearApply.jvp_calls - jvps >= res.inner_iters
    assert stencil_spmv.launches == 0 and dia_spmv.launches == 0
    # the positive lower branch, zero on the pad rows
    n = step.operator.n_rows
    assert float(res.x[:n].min()) > 0


@functools.lru_cache(maxsize=None)
def jax_nonlinear_pde(nx=24):
    """examples/nonlinear_pde.py's composition in the JAX package, f64
    (the example's arrays are float64 under x64): its counts and
    states."""
    from trilinos_tpu.galeri import laplace2d as j_laplace2d
    from trilinos_tpu.nonlinear import continuation as j_cont
    from trilinos_tpu.nonlinear import integrate_adaptive as j_adapt
    from trilinos_tpu.nonlinear import newton_krylov as j_newton
    from trilinos_tpu.ops import formats as jF

    a = j_laplace2d(nx, nx)
    dev = jF.csr_to_dia(a)
    n, npad = a.shape[0], dev.n_rows_pad
    h2 = 1.0 / (nx + 1) ** 2
    mask = np.zeros(npad)
    mask[:n] = 1.0
    mj = jnp.asarray(mask)

    def residual(u, lam):
        return mj * (j_spmv(dev, u, impl="xla") - h2 * lam * jnp.exp(u) * mj)

    u0 = jnp.zeros(npad)
    res = j_newton(lambda u: residual(u, 1.0), u0, rtol=0.0, atol=3e-6)
    path = j_cont(residual, res.x, p0=1.0, p_final=6.5, dp0=0.5,
                  arclength=True, max_steps=40, newton_rtol=0.0,
                  newton_atol=1e-5)
    tr = j_adapt(lambda t, u: mj * (1.0 * jnp.exp(u) * mj
                                    - j_spmv(dev, u, impl="xla") / h2),
                 u0, 0.0, 1.0, 0.02, order=2, rtol=1e-5, newton_atol=1e-5)
    return res, path, tr


def test_nonlinear_pde_entry_matches_the_example():
    """nonlinear_pde_entry at nx = 24, f64, against the example's
    composition. The steady Newton solve: its counts, x to 1e-10. The
    example's continuation and march keep its float32 tolerances (Newton
    atol 1e-5), so a corrector or stage stops wherever its residual first
    falls below 1e-5, and a rounding difference in GMRES moves that stop by
    one iteration near the fold or in a late march stage (λ's 5e-7 apart,
    the march's Newton count one apart here): the continuation's points
    and rejections and the march's steps and rejections are held equal,
    the march's Newton iterations to ±1, λ's and states to the Newton atol
    1e-5."""
    out = nonlinear_pde_entry(24, dtype=np.float64, device="cpu")
    res, path, tr = jax_nonlinear_pde()
    assert out["newton_converged"] and bool(res.converged)
    assert (out["newton_iters"], out["newton_inner"]) == (
        int(res.iters), int(res.inner_iters))
    assert np.abs(out["u_steady"].numpy() - np.asarray(res.x)).max() <= 1e-10
    assert (out["cont_points"], out["cont_failed"]) == (
        len(path.params), path.steps_failed)
    np.testing.assert_allclose(out["lambdas"], path.params, rtol=0,
                               atol=1e-5)
    assert abs(out["cont_max_u"] - float(jnp.max(path.xs[-1]))) <= 1e-5
    assert (out["march_steps"], out["march_rejected"]) == (tr.steps,
                                                           tr.rejected)
    assert abs(out["march_newton"] - tr.newton_iters) <= 1
    assert np.abs(out["u_march"].numpy() - np.asarray(tr.u)).max() <= 1e-5
    assert out["drift"] < 1e-2  # the example's settling check


PHALANX_N = 12


@functools.lru_cache(maxsize=None)
def jax_phalanx(n=PHALANX_N):
    """The JAX package's JFNK on the nonlinear Poisson DAG, n × n Q1
    quadrilaterals, unpreconditioned and with the uncoupled SaAmg of
    poisson_dirichlet's K_ii on the interior rows."""
    from trilinos_tpu import fem as j_fem
    from trilinos_tpu.fem.phalanx import FieldManager as JFieldManager
    from trilinos_tpu.fem.phalanx import PhysicsBlock as JPhysicsBlock
    from trilinos_tpu.nonlinear import newton_krylov as j_newton

    fm = JFieldManager()
    fm.add("kappa", provides="kappa_qp", requires="u_qp")(
        lambda u: 1.0 + u * u)
    fm.add("flux", provides="flux_qp", requires=("kappa_qp", "grad_u_qp"))(
        lambda k, g: k[..., None] * g)
    fm.add("source", provides="source_qp", requires="x_qp")(
        lambda x: 4.0 * jnp.ones(x.shape[:-1], x.dtype))
    mesh = j_fem.structured_quad_mesh(n, n)
    pb = JPhysicsBlock(mesh, dtype=jnp.float64)
    bnd = pb.boundary_dofs()
    r = pb.residual_function(fm, dirichlet=bnd)
    kii, _, interior, _ = j_fem.poisson_dirichlet(
        mesh, lambda x: np.full(x.shape[:-1], 4.0))
    amg = JSaAmg(kii, {"dtype": np.float64,
                       "aggregation: type": "uncoupled"}).compute()
    st = amg.state()
    npad = (st["levels"][0]["a"].n_rows_pad if st["levels"]
            else st["coarse_inv"].shape[0])
    inner = jnp.asarray(interior)

    def prec(v):
        z = jnp.zeros(npad).at[:len(interior)].set(v[inner])
        return v.at[inner].set(amg.apply_state(st, z)[:len(interior)])

    x0 = jnp.zeros(pb.n_dof)
    return (j_newton(r, x0, rtol=1e-10),
            j_newton(r, x0, rtol=1e-10, prec_factory=lambda x: prec))


@pytest.mark.parametrize("with_amg", [False, True])
def test_phalanx_entry_matches_jax(with_amg):
    """phalanx_entry at 12², f64: JFNK through the DAG residual, bare and
    with the fixed AMG preconditioner (interior rows) — the JAX package's
    Newton and GMRES counts and x to 1e-10; ‖F‖ ≤ 1e-8."""
    amg = phalanx_amg(PHALANX_N, device="cpu") if with_amg else None
    step, (u0, st) = phalanx_entry(PHALANX_N, device="cpu", amg=amg)
    res = step(u0, st)
    jres = jax_phalanx()[int(with_amg)]
    assert res.converged and bool(jres.converged)
    assert (res.iters, res.inner_iters) == (int(jres.iters),
                                            int(jres.inner_iters))
    assert np.abs(res.x.numpy() - np.asarray(jres.x)).max() <= 1e-10
    assert float(torch.linalg.norm(step.residual(res.x))) <= 1e-8
