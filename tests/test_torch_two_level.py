"""The port's two-level overlapping Schwarz (FROSch: GDSW/RGDSW and
constant coarse spaces, hybrid and additive coupling) against the JAX
package's.

Both packages set up from one host matrix (Galeri ``laplace2d`` 24² and
``recirc2d`` 24², f64) and the box partition that the JAX package's
``partition_multijagged`` gives (the port has no partitioner yet): the
coarse basis Φ and A0⁻¹ equal the reference's to 1e-12, applies on (n,)
and (n, 3) agree to 1e-12 (max|Δ| / max|y|), also from the JAX state
carried over by ``convert.two_level_schwarz_from_numpy``, and CG with the
"add" combine takes the reference's iteration count on 2×2 and 4×4 boxes
and fewer than one-level Schwarz on 4×4. On the CPU the hybrid coupling's
A·x takes the DIA kernel's plain version (no launch).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trilinos_tpu import precond as jprec
from trilinos_tpu.galeri import laplace2d as j_laplace2d
from trilinos_tpu.galeri import recirc2d as j_recirc2d
from trilinos_tpu.ops import csr_to_dia as j_csr_to_dia
from trilinos_tpu.ops import spmv as j_spmv
from trilinos_tpu.parallel.partition import partition_multijagged
from trilinos_tpu.solvers import cg as j_cg

from trilinos_tpu_torch import precond as tprec
from trilinos_tpu_torch.convert import two_level_schwarz_from_numpy
from trilinos_tpu_torch.ops import DiaMatrix, dia_spmv, spmv
from trilinos_tpu_torch.ops import formats as TF
from trilinos_tpu_torch.solvers import cg
from torch_threads import one_thread  # noqa: F401  (autouse)

TOL = 1e-12
NX = 24
MATRICES = {"laplace2d": j_laplace2d(NX, NX),
            "recirc2d": j_recirc2d(NX, NX, diff=1e-2)}


def port_csr(a):
    return TF.CsrHost(a.row_ptr, a.cols, a.vals, a.shape)


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def boxes(k):
    coords = np.stack(np.meshgrid(np.arange(NX), np.arange(NX),
                                  indexing="xy"), axis=-1).reshape(-1, 2)
    return partition_multijagged(coords, (k, k))


def params(k, **kw):
    return {"schwarz: num subdomains": k * k,
            "schwarz: subdomain ids": boxes(k), **kw}


def both(a, p):
    jm = jprec.TwoLevelSchwarz(a, dict(p)).compute()
    tm = tprec.TwoLevelSchwarz(port_csr(a), dict(p), device="cpu").compute()
    return jm, tm


def applies_match(jm, tm, npad):
    rng = np.random.default_rng(5)
    for shape in ((npad,), (npad, 3)):
        r = rng.standard_normal(shape)
        want = np.asarray(jm(jnp.asarray(r)))
        got = tm(torch.from_numpy(r)).numpy()
        assert got.shape == want.shape
        assert rel(got, want) <= TOL


@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("space", ["rgdsw", "constant"])
@pytest.mark.parametrize("coupling", ["hybrid", "additive"])
def test_two_level_matches_jax(name, space, coupling):
    a = MATRICES[name]
    p = params(2, **{"coarse space: type": space,
                     "coarse space: coupling": coupling})
    jm, tm = both(a, p)
    assert rel(tm.phi.numpy(), np.asarray(jm.phi)) <= TOL
    assert rel(tm.a0_inv.numpy(), np.asarray(jm.a0_inv)) <= TOL
    np.testing.assert_array_equal(tm.a0_inv.numpy(), tm.a0_inv.numpy().T)
    assert tm.coarse_dim == jm.coarse_dim == 4
    dia_spmv.launches = 0
    applies_match(jm, tm, jm.npad)
    assert dia_spmv.launches == 0
    if coupling == "hybrid":
        assert isinstance(tm.a_dev, DiaMatrix)
    if space == "rgdsw" and coupling == "hybrid":
        l1 = jm.level1
        carried = two_level_schwarz_from_numpy(
            port_csr(a), np.asarray(jm.phi), np.asarray(jm.a0_inv),
            np.asarray(l1.inv), np.asarray(l1.gather),
            np.asarray(l1.weight), dict(p), device="cpu")
        applies_match(jm, carried, jm.npad)


def test_empty_subdomain_and_bad_ids():
    a = MATRICES["laplace2d"]
    p = params(2, **{"schwarz: num subdomains": 5,
                     "coarse space: type": "constant"})
    jm, tm = both(a, p)
    assert float(tm.a0_inv[4, 4]) == float(jm.a0_inv[4, 4]) == 1.0
    applies_match(jm, tm, jm.npad)
    with pytest.raises(ValueError, match="subdomain ids"):
        tprec.TwoLevelSchwarz(port_csr(a), params(2, **{
            "schwarz: num subdomains": 3}), device="cpu").compute()
    with pytest.raises(TypeError, match="CsrHost"):
        tprec.TwoLevelSchwarz(None, device="cpu").compute()


@pytest.fixture(scope="module")
def cg_problem():
    a = MATRICES["laplace2d"]
    jdev = j_csr_to_dia(a)
    tdev = TF.csr_to_dia(port_csr(a), device="cpu")
    n, npad = a.shape[0], jdev.n_rows_pad
    b = np.zeros(npad)
    b[:n] = np.random.default_rng(0).standard_normal(n)
    return a, jdev, tdev, b


@pytest.mark.parametrize("k", [2, 4])
def test_cg_iterations_match_jax(cg_problem, k):
    """CG at rtol 1e-8 with the symmetric "add" combine: the reference's
    iteration count, and on 4×4 boxes fewer than one-level Schwarz (the
    coarse level's reason for being)."""
    a, jdev, tdev, b = cg_problem
    p = params(k, **{"schwarz: combine mode": "add"})
    jm, tm = both(a, p)
    jres = j_cg(lambda x: j_spmv(jdev, x, impl="xla"), jnp.asarray(b),
                prec=jm, rtol=1e-8, maxiter=500)
    res = cg(lambda x: spmv(tdev, x), torch.from_numpy(b), prec=tm,
             rtol=1e-8, maxiter=500)
    assert bool(res.converged) and bool(jres.converged)
    assert res.iters == int(jres.iters)
    assert rel(res.x.numpy(), jres.x) <= 1e-8
    if k == 4:
        one = cg(lambda x: spmv(tdev, x), torch.from_numpy(b),
                 prec=tm.level1, rtol=1e-8, maxiter=500)
        assert res.iters < one.iters


def test_default_partition_matches_jax():
    """The default partition (contiguous row chunks, here slabs of six grid
    lines) through create(). On slabs the RGDSW basis of both packages is
    rank-deficient (the alternating sum of the four functions vanishes),
    so A0 is singular and its inverse amplifies rounding: the basis is held
    to the reference's and the apply is compared on the constant space."""
    a = MATRICES["recirc2d"]
    for name in ("TWO-LEVEL SCHWARZ", "FROSCH", "GDSW"):
        tm = tprec.create(name, port_csr(a), device="cpu").compute()
        assert isinstance(tm, tprec.TwoLevelSchwarz)
    jm = jprec.create("GDSW", a).compute()
    assert rel(tm.phi.numpy(), np.asarray(jm.phi)) <= TOL
    for phi in (tm.phi.numpy(), np.asarray(jm.phi)):
        assert np.linalg.matrix_rank(phi) == 3
    p = {"coarse space: type": "constant"}
    applies_match(jprec.create("FROSCH", a, dict(p)).compute(),
                  tprec.create("FROSCH", port_csr(a), p,
                               device="cpu").compute(), jm.npad)
