"""Port parity: structured AMG-PCG with the Chebyshev smoother.

The fine level smooths with one stencil polynomial apply (degree sweeps+1
= 3, Gershgorin λmax); the coarse DIA levels keep damped Jacobi. The
``cheb_entry`` twin at 16³ must take the JAX package's iteration count
with x to 1e-9 in f64, and within one iteration and 1e-4 in f32. The
port's Chebyshev hierarchy must also apply the JAX package's state.
"""
import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trilinos_tpu.galeri import laplace3d as j_laplace3d
from trilinos_tpu.ops import spmv as j_spmv
from trilinos_tpu.precond import SaAmg as JSaAmg
from trilinos_tpu.solvers import cg as j_cg

from trilinos_tpu_torch.convert import amg_state_from_jax
from trilinos_tpu_torch.entry import cheb_entry
from trilinos_tpu_torch.galeri import laplace3d
from trilinos_tpu_torch.ops import stencil_poly as tp
from trilinos_tpu_torch.precond import SaAmg
from torch_threads import one_thread  # noqa: F401  (autouse)


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def cheb64():
    """The f64 Chebyshev hierarchies of both packages on Laplace3D 16³,
    built once (the port's host set-up takes seconds)."""
    dims = (16, 16, 16)
    params = {"smoother: type": "chebyshev", "dtype": np.float64}
    jm = JSaAmg(j_laplace3d(*dims, fmt="stencil"), params).compute()
    tm = SaAmg(laplace3d(*dims, fmt="stencil"), params,
               device="cpu").compute()
    return jm, tm


def jax_cheb_entry(dtype, m=None):
    """``entry()``'s body with the Chebyshev smoother, in ``dtype``."""
    op = j_laplace3d(16, 16, 16, dtype=dtype, fmt="stencil")
    if m is None:
        m = JSaAmg(op, {"smoother: type": "chebyshev",
                        "dtype": dtype}).compute()
    b = np.zeros(op.n_rows_pad, dtype)
    b[:op.n_rows] = np.random.default_rng(0).standard_normal(op.n_rows)
    st = m.state()
    return j_cg(lambda v: j_spmv(op, v), jnp.asarray(b),
                prec=lambda v: m.apply_state(st, v), rtol=1e-5, maxiter=50)


@pytest.mark.parametrize("dtype,max_diters,tol", [
    (np.float64, 0, 1e-9), (np.float32, 1, 1e-4)])
def test_cheb_entry_twin_matches_jax(dtype, max_diters, tol, cheb64):
    jm, tm = cheb64 if dtype == np.float64 else (None, None)
    step, (b, state) = cheb_entry(dtype=dtype, device="cpu", amg=tm)
    res = step(b, state)
    jres = jax_cheb_entry(dtype, jm)
    assert bool(res.converged) and bool(jres.converged)
    assert abs(res.iters - int(jres.iters)) <= max_diters
    assert rel(res.x.numpy(), jres.x) <= tol
    assert tp.stencil_poly_apply.launches == 0


def test_cheb_apply_state_from_jax(cheb64):
    """A Chebyshev hierarchy applies the JAX package's state: the fine
    level's polynomial comes from the port's hierarchy, the level
    operators and diagonals from the JAX one."""
    jm, tm = cheb64
    assert tm.levels[0]["cheb"] is not None
    assert all("cheb" not in lvl for lvl in tm.levels[1:])
    st = amg_state_from_jax(jax.tree_util.tree_map(np.asarray, jm.state()),
                            (16, 16, 16), device="cpu")
    r = torch.from_numpy(
        np.random.default_rng(12).standard_normal(tm.levels[0]["n_f"]))
    assert rel(tm.apply_state(st, r).numpy(), tm.apply(r).numpy()) <= 1e-12
    with pytest.raises(ValueError, match="chebyshev smoother"):
        cheb_entry(amg=SaAmg(laplace3d(8, 8, 8, fmt="stencil"),
                             device="cpu").compute())
