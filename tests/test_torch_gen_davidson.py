"""The port's Generalized Davidson against the JAX package's.

LM on the nonsymmetric Galeri ``uniflow2d`` 8 × 8 (convection 1,
diffusion 0.1, block size 1) and SR on ``laplace2d`` 16 × 8 with the mass
2I (nev 2), each from the start block the solver draws itself
(``default_rng(13)``, the same host array in both packages): iteration
counts equal, eigenvalues to 1e-10, residual norms to 1e-8, the Schur
basis (formed on the device) by the subspace projector to 1e-8, and each
returned pair's true residual. Each JAX solve runs once.

Generalized Davidson amplifies rounding wherever a wanted pair converges
slowly: the same pencil at nev 3 takes 156 iterations in the JAX package
and 165 in the port, ``uniflow2d`` at block size 2 takes 94 and 95 and at
block size 3 83 and a stall at the iteration limit, with iterates that
agree to rounding for the first 90 iterations. The twins are the settings
in which every wanted pair converges steadily.
"""
import functools

import numpy as np
import pytest
import torch

from trilinos_tpu.eigen import generalized_davidson as j_gen_davidson
from trilinos_tpu.galeri import laplace2d, uniflow2d
from trilinos_tpu.ops import formats as JF
from trilinos_tpu.ops import matvec as JS

from trilinos_tpu_torch.eigen import EigsResult, generalized_davidson
from trilinos_tpu_torch.ops import formats as TF
from trilinos_tpu_torch.ops import matvec as TS
from torch_threads import one_thread  # noqa: F401  (autouse)

EIG_RTOL = 1e-10
RES_ATOL = 1e-8
VEC_TOL = 1e-8


def ell_pair(a):
    """(JAX op, port op, n_pad) of one host matrix stored as ELL."""
    ja = JF.csr_to_ell(a)
    ta = TF.csr_to_ell(TF.CsrHost(a.row_ptr, a.cols, a.vals, a.shape),
                       device="cpu")
    return ((lambda v: JS.spmv(ja, v)), (lambda v: TS.spmv(ta, v)),
            ja.n_rows_pad)


MATS = {"uniflow": uniflow2d(8, 8, conv=1.0, diff=0.1),
        "lap16": laplace2d(16, 8)}
OPS = {k: ell_pair(a) for k, a in MATS.items()}
CASES = {  # name: (matrix, nev, mass 2I, keywords)
    "LM": ("uniflow", 2, False, dict(nb=1, which="LM", tol=1e-8,
                                     maxiter=300)),
    "SR-mass": ("lap16", 2, True, dict(which="SR", tol=1e-9, maxiter=300)),
}


def _run(case, jax_side):
    name, nev, mass2, kw = CASES[case]
    jop, top, n = OPS[name]
    m = (lambda v: 2.0 * v) if mass2 else None
    if jax_side:
        return j_gen_davidson(jop, n, nev, m=m, **kw)
    return generalized_davidson(top, n, nev, m=m, device="cpu", **kw)


@functools.lru_cache(maxsize=None)
def jax_result(case):
    return _run(case, True)


def projector_gap(x, y, vals):
    """max over clusters of equal |eigenvalue| (relative gap < 1e-6; a
    conjugate pair's columns span its real invariant subspace) of
    |P_x − P_y|, P the orthogonal projector onto the cluster's columns."""
    x, y = np.asarray(x), np.asarray(y)
    mags = np.abs(np.asarray(vals))
    worst, done = 0.0, set()
    for i in range(len(mags)):
        if i in done:
            continue
        idx = [j for j in range(len(mags))
               if abs(mags[j] - mags[i]) <= 1e-6 * mags[i]]
        done.update(idx)
        qx, qy = np.linalg.qr(x[:, idx])[0], np.linalg.qr(y[:, idx])[0]
        worst = max(worst, np.abs(qx @ qx.T - qy @ qy.T).max())
    return worst


@pytest.mark.parametrize("case", list(CASES))
def test_generalized_davidson_matches_jax(case):
    jr, tr = jax_result(case), _run(case, False)
    assert isinstance(tr, EigsResult)
    assert isinstance(tr.eigenvectors, torch.Tensor)
    assert tr.converged and jr.converged
    assert tr.iters == jr.iters < CASES[case][3]["maxiter"]
    np.testing.assert_allclose(tr.eigenvalues, jr.eigenvalues, rtol=EIG_RTOL)
    np.testing.assert_allclose(tr.resnorms, jr.resnorms, rtol=0,
                               atol=RES_ATOL)
    assert projector_gap(jr.eigenvectors, tr.eigenvectors.numpy(),
                         jr.eigenvalues) <= VEC_TOL
    name, _, mass2, kw = CASES[case]
    lam = torch.from_numpy(tr.eigenvalues.real)
    x = tr.eigenvectors
    r = OPS[name][1](x) - (2.0 if mass2 else 1.0) * x * lam[None, :]
    assert (torch.linalg.vector_norm(r, dim=0)
            <= 10 * kw["tol"] * torch.clamp(lam.abs(), min=1)).all()


def test_generalized_davidson_finds_the_wanted_eigenvalues():
    wu = np.linalg.eigvals(MATS["uniflow"].to_dense())
    got = np.sort(np.abs(jax_result("LM").eigenvalues[:2]))
    np.testing.assert_allclose(got, np.sort(np.abs(wu))[-2:], rtol=1e-6)
    w = np.linalg.eigvalsh(MATS["lap16"].to_dense())
    np.testing.assert_allclose(np.sort(jax_result("SR-mass").eigenvalues
                                       .real[:2]), w[:2] / 2, rtol=1e-8)
