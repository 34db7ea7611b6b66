"""The port's main path as a whole: the twin of ``__graft_entry__.entry()``.

Structured-AMG-preconditioned CG on Laplace3D 16³: in f64 the port must
take the same number of CG iterations as the JAX package and reach the
same solution to 1e-9 (max|Δ| / max|x|); in f32, within one iteration and
1e-4. The elasticity paths at 8³ (block-AMG PCG, plane-layout CG) in f64:
the JAX bench's solves, the same iteration count and x to 1e-10. Also: the
port imports neither JAX nor the JAX package, entry points refuse to run
without a card unless asked for the CPU, the kernel launch counters stay 0
on the CPU, and float32 matmuls stay in full precision.
"""
import ast
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
                                      bsr_gmres_entry, cheb_entry,
                                      elasticity_entry, entry,
                                      fused_cg_entry, gmres_entry,
                                      sstep_entry)
from trilinos_tpu_torch.galeri import (elasticity3d, laplace3d,
                                       rigid_body_modes)
from trilinos_tpu_torch.ops import (bdia_spmm, bdia_spmv, cg_fused_iteration,
                                    dia_spmv, spgemm, spmv,
                                    stencil_poly_apply, stencil_powers_apply,
                                    stencil_spmv)
from trilinos_tpu_torch.precond import BlockStructuredAmg, SaAmg

ROOT = pathlib.Path(__file__).resolve().parent.parent


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
    ja = jfem.elasticity3d(*dims, e_mod=1.0)
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
    ja = j_csr_to_bdia(jfem.elasticity3d(8, 8, 8, e_mod=1.0), 3)
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
    assert len(files) > 20
    names = {f.relative_to(ROOT).as_posix() for f in files}
    assert {"trilinos_tpu_torch/ops/smalldense.py",
            "trilinos_tpu_torch/solvers/ortho.py",
            "trilinos_tpu_torch/solvers/block_gmres.py",
            "trilinos_tpu_torch/ops/stencil_poly.py",
            "trilinos_tpu_torch/ops/cg_fused.py",
            "trilinos_tpu_torch/precond/chebyshev.py",
            "trilinos_tpu_torch/eigen/lanczos.py",
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
            "trilinos_tpu_torch/solvers/linear_problem.py"} <= names
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "trilinos_tpu"), (f, mod)


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()
    for fn in (block_entry, cheb_entry, sstep_entry, fused_cg_entry,
               elasticity_entry, bdia_cg_entry, gmres_entry,
               bsr_gmres_entry):
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
