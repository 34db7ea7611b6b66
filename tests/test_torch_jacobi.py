"""The port's Jacobi-family preconditioners and factory against the JAX
package's.

``Relaxation`` (Jacobi and l1 Jacobi, 1 and 3 sweeps, damping 0.7) and
``BlockJacobi`` built by both packages from one host matrix and one
parameter set: the same inverse diagonal, and applies on (n,) and (n, k)
to 1e-13 relative, f64. ``convert.relaxation_from_numpy`` carries the JAX
state over. ``create`` builds every name of the reference's table: the
names freed by the direct solvers (the two-level Schwarz and Amesos2
families) create, compute and apply as the JAX package's create does, to
1e-12; an unknown name raises ValueError, as in the reference.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trilinos_tpu import precond as jprec
from trilinos_tpu.galeri import stencils as jst
from trilinos_tpu.ops import formats as JF

from trilinos_tpu_torch import precond as tprec
from trilinos_tpu_torch.convert import relaxation_from_numpy
from trilinos_tpu_torch.ops import DiaMatrix, dia_spmv
from trilinos_tpu_torch.ops import formats as TF
from torch_threads import one_thread  # noqa: F401  (autouse)

TOL = 1e-13


def port_csr(a):
    return TF.CsrHost(a.row_ptr, a.cols, a.vals, a.shape)


def rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def applies_match(jm, tm, n_pad, seed=3):
    rng = np.random.default_rng(seed)
    for shape in ((n_pad,), (n_pad, 3)):
        x = rng.standard_normal(shape)
        want = np.asarray(jm(jnp.asarray(x)))
        got = tm(torch.from_numpy(x)).numpy()
        assert got.shape == want.shape
        assert rel(got, want) <= TOL, rel(got, want)


@pytest.mark.parametrize("kind", ["Jacobi", "l1 Jacobi"])
@pytest.mark.parametrize("sweeps", [1, 3])
def test_relaxation_matches_jax(kind, sweeps):
    # a nonsymmetric stencil matrix whose diagonal varies row to row
    a = jst.recirc2d(9, 7, diff=1e-2)
    params = {"relaxation: type": kind, "relaxation: sweeps": sweeps,
              "relaxation: damping factor": 0.7}
    jm = jprec.Relaxation(a, dict(params)).compute()
    tm = tprec.Relaxation(port_csr(a), dict(params), device="cpu").compute()
    np.testing.assert_allclose(tm.dinv.numpy(), np.asarray(jm.dinv),
                               rtol=1e-15)
    assert (tm.omega, tm.sweeps) == (jm.omega, jm.sweeps)
    if sweeps > 1:
        # choose_format's matrix: DIA on a stencil, so the sweeps run the
        # DIA kernel on the card
        assert isinstance(tm._dev, DiaMatrix)
    applies_match(jm, tm, jm.dinv.shape[0])
    # the JAX state carried into the port applies the same
    cm = relaxation_from_numpy(port_csr(a), np.asarray(jm.dinv), jm.omega,
                               jm.sweeps, device="cpu")
    applies_match(jm, cm, jm.dinv.shape[0])


def test_relaxation_sweeps_count_dia_applies():
    a = jst.laplace2d(8, 8)
    tm = tprec.Relaxation(port_csr(a), {"relaxation: sweeps": 3},
                          device="cpu").compute()
    before = dia_spmv.launches
    tm(torch.ones(64, dtype=torch.float64))
    assert dia_spmv.launches == before  # the CPU runs the plain version
    with pytest.raises(TypeError, match="CsrHost"):
        tprec.Relaxation(np.eye(4), device="cpu").compute()
    with pytest.raises(ValueError, match="not in"):
        tprec.Relaxation(port_csr(a), {"relaxation: type": "SOR"},
                         device="cpu").compute()


@pytest.mark.parametrize("bs", [4, 3])
def test_block_jacobi_matches_jax(bs):
    # 50 rows: with bs = 3 the last block is short and the blocks are padded
    a = jst.recirc2d(10, 5, diff=1e-2)
    p = {"partitioner: block size": bs}
    jm = jprec.BlockJacobi(a, dict(p)).compute()
    tm = tprec.BlockJacobi(port_csr(a), dict(p), device="cpu").compute()
    np.testing.assert_allclose(tm.inv_blocks.numpy(),
                               np.asarray(jm.inv_blocks), rtol=1e-15)
    n_pad = JF.round_up(a.shape[0], JF.ROW_ALIGN)
    applies_match(jm, tm, n_pad)


PORTED = ["JACOBI", "Relaxation", "block_jacobi", "SA-AMG", "AMG", "MueLu"]
# CHEBYSHEV and GMRESPOLY are ported now (tests/test_torch_poly_cheb.py)
# the ILU family, the containers, Gauss-Seidel, Schwarz and Hiptmair are
# ported now (tests/test_torch_ilu.py, tests/test_torch_relaxation_blocks.py);
# the names below were freed by the direct solvers
# (tests/test_torch_direct.py, tests/test_torch_two_level.py)
FREED = ["GDSW", "KLU2", "TWO-LEVEL SCHWARZ", "FROSCH", "AMESOS2", "DIRECT",
         "TACHO", "CHOLMOD", "Klu2"]


@pytest.mark.parametrize("name", PORTED)
def test_create_builds_ported_names(name):
    if "AMG" in name.upper() or name == "MueLu":
        a = laplace3d_stencil()
        m = tprec.create(name, a, {"dtype": np.float64}, device="cpu")
        assert isinstance(m, tprec.SaAmg)
        m.compute()
        assert len(m.levels) >= 1
        return
    a = port_csr(jst.laplace2d(6, 6))
    m = tprec.create(name, a, device="cpu").compute()
    want = tprec.BlockJacobi if "BLOCK" in name.upper() else tprec.Relaxation
    assert type(m) is want
    assert m(torch.ones(40, dtype=torch.float64)).shape == (40,)


def test_create_block_amg_name():
    from trilinos_tpu_torch.galeri import elasticity3d, rigid_body_modes

    a = elasticity3d(2, 2, 2, e_mod=1.0)
    m = tprec.create("block sa-amg", a, {"coarse: max size": 3000},
                     node_dims=(2, 2, 2), nullspace=rigid_body_modes(2, 2, 2),
                     n_equations=3, device="cpu")
    assert isinstance(m, tprec.BlockStructuredAmg)


@pytest.mark.parametrize("name", FREED)
def test_create_builds_freed_names(name):
    """Each freed name through both packages' create() on laplace2d 12²
    (four box subdomains of 6², f64): the same class, the apply to 1e-12
    on (n,) and (n, 3); the caller's parameters keep no added solver."""
    from trilinos_tpu_torch.precond import DirectPrec, TwoLevelSchwarz

    a = jst.laplace2d(12, 12)
    params = {}
    if "SCHWARZ" in name.upper() or name in ("GDSW", "FROSCH"):
        i = np.arange(144)
        params = {"schwarz: num subdomains": 4,
                  "schwarz: subdomain ids": (i // 72) * 2 + (i % 12) // 6}
    jm = jprec.create(name, a, dict(params)).compute()
    tm = tprec.create(name, port_csr(a), params, device="cpu").compute()
    assert type(tm) is (DirectPrec if type(jm).__name__ == "DirectPrec"
                        else TwoLevelSchwarz)
    assert "solver" not in params
    rng = np.random.default_rng(3)
    for shape in ((144,), (144, 3)):
        x = rng.standard_normal(shape)
        want = np.asarray(jm(jnp.asarray(x)))
        got = tm(torch.from_numpy(x)).numpy()
        assert got.shape == want.shape
        assert rel(got, want) <= 1e-12, rel(got, want)


def test_create_unknown_name():
    with pytest.raises(ValueError, match="unknown preconditioner"):
        tprec.create("no such thing", None)
    with pytest.raises(ValueError, match="unknown preconditioner"):
        jprec.create("no such thing", None)


def laplace3d_stencil():
    from trilinos_tpu_torch.galeri import laplace3d

    return laplace3d(8, 8, 8, dtype=np.float64, fmt="stencil")
