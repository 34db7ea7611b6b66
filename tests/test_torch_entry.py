"""The port's main path as a whole: the twin of ``__graft_entry__.entry()``.

Structured-AMG-preconditioned CG on Laplace3D 16³: in f64 the port must
take the same number of CG iterations as the JAX package and reach the
same solution to 1e-9 (max|Δ| / max|x|); in f32, within one iteration and
1e-4. Also: the port imports neither JAX nor the JAX package, entry points
refuse to run without a card unless asked for the CPU, the kernel launch
counters stay 0 on the CPU, and float32 matmuls stay in full precision.
"""
import ast
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trilinos_tpu.galeri import laplace3d as j_laplace3d
from trilinos_tpu.ops import spmv as j_spmv
from trilinos_tpu.precond import SaAmg as JSaAmg
from trilinos_tpu.solvers import cg as j_cg

import trilinos_tpu_torch
from trilinos_tpu_torch.entry import (block_entry, cheb_entry, entry,
                                      fused_cg_entry, sstep_entry)
from trilinos_tpu_torch.ops import (cg_fused_iteration, dia_spmv,
                                    stencil_poly_apply, stencil_powers_apply,
                                    stencil_spmv)

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
    its plain version, so the kernels' counters stay 0, the stage counts of
    the polynomial wrappers too."""
    counters = (stencil_poly_apply, stencil_powers_apply, cg_fused_iteration,
                stencil_spmv)
    for fn in counters:
        fn.launches = 0
    stencil_poly_apply.stage_launches = 0
    stencil_powers_apply.stage_launches = 0
    step, (b,) = sstep_entry(device="cpu")
    assert step(b).iters == 160
    step, (b,) = fused_cg_entry(device="cpu")
    assert bool(step(b).converged)
    assert [fn.launches for fn in counters] == [0, 0, 0, 0]
    assert stencil_poly_apply.stage_launches == 0
    assert stencil_powers_apply.stage_launches == 0


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
            "trilinos_tpu_torch/solvers/sstep_gmres.py"} <= names
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "trilinos_tpu"), (f, mod)


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()
    for fn in (block_entry, cheb_entry, sstep_entry, fused_cg_entry):
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
