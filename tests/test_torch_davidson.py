"""The port's Block Davidson against the JAX package's.

LA with locking (at most two locked pairs) on Galeri ``laplace2d``
16 × 8, and SA on the generalized pencil of a P1 stiffness/mass pair (the
JAX package's smallest test mesh: M-orthonormal search space, whitened
Rayleigh-Ritz, host quality filter). The same seeded start blocks go
through both packages in f64: iteration counts equal, eigenvalues to
1e-10, residual norms to 1e-8, and the returned vectors (formed on the
device: the locked prefix and the active Ritz block) by the subspace
projector of each cluster to 1e-8. Each JAX solve runs once (nearly all
of this file's time is the JAX package's compiles of one step program per
search-space width). Block Davidson SA without a mass and Generalized
Davidson (nonsymmetric, and with a mass) run through both packages'
factories in ``tests/test_torch_eigen_factory.py``.
"""
import functools

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from trilinos_tpu.eigen import block_davidson as j_block_davidson
from trilinos_tpu.fem.assembly import mass_matrix, stiffness_matrix
from trilinos_tpu.fem.mesh import structured_tri_mesh
from trilinos_tpu.galeri import laplace2d
from trilinos_tpu.ops import formats as JF
from trilinos_tpu.ops import matvec as JS

from trilinos_tpu_torch.eigen import EigsResult, block_davidson
from trilinos_tpu_torch.ops import formats as TF
from trilinos_tpu_torch.ops import matvec as TS
from torch_threads import one_thread  # noqa: F401  (autouse)

EIG_RTOL = 1e-10
RES_ATOL = 1e-8
VEC_TOL = 1e-8


def ell_pair(a):
    """(JAX op, port op, n_pad, n) of one host matrix stored as ELL."""
    ja = JF.csr_to_ell(a)
    ta = TF.csr_to_ell(TF.CsrHost(a.row_ptr, a.cols, a.vals, a.shape),
                       device="cpu")
    return ((lambda v: JS.spmv(ja, v)), (lambda v: TS.spmv(ta, v)),
            ja.n_rows_pad, a.shape[0])


def fe_pencil():
    """Dirichlet-interior P1 stiffness and mass on a 9 × 9 triangulated
    unit square, as JAX CsrHost matrices."""
    mesh = structured_tri_mesh(9, 9)
    k, _, xy = stiffness_matrix(mesh)
    m, _, _ = mass_matrix(mesh)
    inner = np.nonzero((xy[:, 0] > 1e-12) & (xy[:, 0] < 1 - 1e-12)
                       & (xy[:, 1] > 1e-12) & (xy[:, 1] < 1 - 1e-12))[0]
    out = []
    for a in (k, m):
        s = sp.csr_matrix((a.vals, a.cols, a.row_ptr), shape=a.shape)[
            np.ix_(inner, inner)].tocsr()
        out.append(JF.CsrHost(s.indptr.astype(np.int64), s.indices, s.data,
                              s.shape))
    return out


K_FE, M_FE = fe_pencil()
MATS = {"lap16": laplace2d(16, 8), "fe": K_FE}
OPS = {k: ell_pair(a) for k, a in MATS.items()}
MASS = {"fe": ell_pair(M_FE)[:2]}


def start(name, width, seed):
    """Seeded normals, zero in the pad rows."""
    _, _, npad, n = OPS[name]
    v = np.zeros((npad, width))
    v[:n] = np.random.default_rng(seed).standard_normal((n, width))
    return v


CASES = {  # name: (matrix, mass, nev, start, keywords)
    "BD-LA-locking": ("lap16", None, 3, start("lap16", 3, 2),
                      dict(which="LA", tol=1e-9, maxiter=300, locking=True,
                           max_locked=2)),
    "BD-SA-mass": ("fe", "fe", 4, start("fe", 4, 5),
                   dict(which="SA", tol=1e-8, maxiter=300)),
}


def _run(case, jax_side):
    name, mass, nev, v0, kw = CASES[case]
    jop, top, npad, _ = OPS[name]
    m = None if mass is None else MASS[mass][0 if jax_side else 1]
    if jax_side:
        return j_block_davidson(jop, npad, nev, v0=jnp.asarray(v0), m=m,
                                **kw)
    return block_davidson(top, npad, nev, v0=torch.from_numpy(v0), m=m,
                          **kw)


@functools.lru_cache(maxsize=None)
def jax_result(case):
    return _run(case, True)


def projector_gap(x, y, vals):
    """max over clusters of equal eigenvalues (relative gap < 1e-6) of
    |P_x − P_y|, P the orthogonal projector onto the cluster's columns."""
    x, y = np.asarray(x), np.asarray(y)
    worst, done = 0.0, set()
    for i in range(len(vals)):
        if i in done:
            continue
        idx = [j for j in range(len(vals))
               if abs(vals[j] - vals[i]) <= 1e-6 * abs(vals[i])]
        done.update(idx)
        qx, qy = np.linalg.qr(x[:, idx])[0], np.linalg.qr(y[:, idx])[0]
        worst = max(worst, np.abs(qx @ qx.T - qy @ qy.T).max())
    return worst


@pytest.mark.parametrize("case", list(CASES))
def test_block_davidson_matches_jax(case):
    jr, tr = jax_result(case), _run(case, False)
    assert isinstance(tr, EigsResult)
    assert isinstance(tr.eigenvectors, torch.Tensor)
    assert tr.converged and jr.converged
    assert tr.iters == jr.iters < CASES[case][4]["maxiter"]
    np.testing.assert_allclose(tr.eigenvalues, jr.eigenvalues, rtol=EIG_RTOL)
    np.testing.assert_allclose(tr.resnorms, jr.resnorms, rtol=0,
                               atol=RES_ATOL)
    jx, tx = np.asarray(jr.eigenvectors), tr.eigenvectors.numpy()
    assert tx.shape == jx.shape
    assert projector_gap(jx, tx, jr.eigenvalues) <= VEC_TOL


def test_block_davidson_finds_the_wanted_eigenvalues():
    """Each case's values are the matrix's (or pencil's) own."""
    import scipy.linalg as sla

    w = np.linalg.eigvalsh(MATS["lap16"].to_dense())
    np.testing.assert_allclose(np.sort(jax_result("BD-LA-locking")
                                       .eigenvalues), w[-3:], rtol=1e-9)
    wm = sla.eigh(K_FE.to_dense(), M_FE.to_dense(), eigvals_only=True)
    np.testing.assert_allclose(jax_result("BD-SA-mass").eigenvalues, wm[:4],
                               rtol=1e-7)


def test_locking_keeps_the_locked_prefix():
    """With locking the first returned vectors are the locked ones and
    every returned pair's true residual honours the tolerance."""
    tr = _run("BD-LA-locking", False)
    _, top, _, _ = OPS["lap16"]
    x = tr.eigenvectors
    r = top(x) - x * torch.from_numpy(tr.eigenvalues)[None, :]
    assert float(torch.linalg.vector_norm(r, dim=0).max()) <= 1e-8
