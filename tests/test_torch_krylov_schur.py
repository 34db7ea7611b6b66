"""The port's block Krylov–Schur against the JAX package's.

Symmetric LM with block size 2 on Galeri ``laplace2d`` 8 × 8 (whose
second and third largest eigenvalues are a double pair), symmetric SR on
``laplace2d`` 16 × 8, nonsymmetric LM on ``recirc2d`` 10 × 10 (Galeri's
default diffusion 1e-5: the four leading eigenvalues are two complex
conjugate pairs; 100 rows in 104 ELL rows whose pad rows are zero) and
the generalized pencil K x = λ M x of a P1 stiffness/mass pair (the JAX
package's smallest test mesh) through the default M⁻¹ (fixed-step CG on
M): the same seeded start vectors through both packages in f64. Total
Arnoldi steps equal, eigenvalues to 1e-10, residual estimates to 1e-8,
eigenvectors (formed on the device, complex for the nonsymmetric pairs)
by the subspace projector of each cluster to 1e-8. The two members of a
conjugate pair tie in |λ|, so their order follows rounding: the port's
pairs are matched to the reference's by value first. Each JAX solve runs
once. The host helpers (``_ordschur``, ``_select_expansion_columns``)
are held to the reference bit for bit on fixed matrices, and the device
Ritz-vector product to the reference's host product to 1e-12.
"""
import functools

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from trilinos_tpu.eigen import block_krylov_schur as j_bks
from trilinos_tpu.eigen.krylov_schur import _ordschur as j_ordschur
from trilinos_tpu.eigen.krylov_schur import (
    _select_expansion_columns as j_select)
from trilinos_tpu.fem.assembly import mass_matrix, stiffness_matrix
from trilinos_tpu.fem.mesh import structured_tri_mesh
from trilinos_tpu.galeri import laplace2d, recirc2d
from trilinos_tpu.ops import formats as JF
from trilinos_tpu.ops import matvec as JS

from trilinos_tpu_torch.eigen import EigsResult, block_krylov_schur
from trilinos_tpu_torch.eigen.krylov_schur import (_ordschur, _ritz_vectors,
                                                   _select_expansion_columns)
from trilinos_tpu_torch.ops import formats as TF
from trilinos_tpu_torch.ops import matvec as TS
from trilinos_tpu_torch.parallel.comm import SerialComm
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
MATS = {"lap8": laplace2d(8, 8), "lap16": laplace2d(16, 8),
        "recirc": recirc2d(10, 10), "fe": K_FE}
OPS = {k: ell_pair(a) for k, a in MATS.items()}
MOPS = ell_pair(M_FE)


def start(name, width, seed):
    """Seeded normals, zero in the pad rows."""
    _, _, npad, n = OPS[name]
    v = np.zeros((npad, width))
    v[:n] = np.random.default_rng(seed).standard_normal((n, width))
    return v


CASES = {  # name: (matrix, nev, start, keywords)
    "sym-LM-nb2": ("lap8", 3, start("lap8", 2, 1),
                   dict(nb=2, which="LM", symmetric=True, tol=1e-9)),
    "sym-SR": ("lap16", 3, start("lap16", 1, 2),
               dict(which="SR", symmetric=True, tol=1e-9)),
    "nonsym-LM": ("recirc", 4, start("recirc", 1, 4),
                  dict(which="LM", tol=1e-9)),
    "mass-SM": ("fe", 4, start("fe", 1, 5),
                dict(which="SM", symmetric=True, tol=1e-8,
                     m_solve_iters=60, mass=True)),
}


def _run(case, jax_side):
    name, nev, v0, kw = CASES[case]
    jop, top, npad, _ = OPS[name]
    kw = dict(kw)
    if kw.pop("mass", False):
        kw["mass"] = MOPS[0] if jax_side else MOPS[1]
    if jax_side:
        return j_bks(jop, npad, nev, v0=jnp.asarray(v0), **kw)
    return block_krylov_schur(top, npad, nev, v0=torch.from_numpy(v0), **kw)


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
        worst = max(worst, np.abs(qx @ qx.conj().T - qy @ qy.conj().T).max())
    return worst


def match_order(want, got):
    """The permutation p with got[p] nearest want, entry by entry."""
    free, p = list(range(len(got))), []
    for w in want:
        j = min(free, key=lambda i: abs(got[i] - w))
        free.remove(j)
        p.append(j)
    return np.asarray(p)


@pytest.mark.parametrize("case", list(CASES))
def test_block_krylov_schur_matches_jax(case):
    jr, tr = jax_result(case), _run(case, False)
    assert isinstance(tr, EigsResult) and isinstance(tr.eigenvectors,
                                                     torch.Tensor)
    assert tr.converged and jr.converged
    assert tr.iters == jr.iters
    p = match_order(jr.eigenvalues, tr.eigenvalues)
    np.testing.assert_allclose(tr.eigenvalues[p], jr.eigenvalues,
                               rtol=EIG_RTOL)
    np.testing.assert_allclose(tr.resnorms[p], jr.resnorms, rtol=0,
                               atol=RES_ATOL)
    assert tr.eigenvectors.dtype == (torch.complex128
                                     if np.iscomplexobj(jr.eigenvectors)
                                     else torch.float64)
    assert projector_gap(jr.eigenvectors, tr.eigenvectors.numpy()[:, p],
                         jr.eigenvalues) <= VEC_TOL


def test_cases_find_the_wanted_eigenvalues():
    """The symmetric cases find the matrices' own extreme eigenvalues
    (the LM case's double pair included), the nonsymmetric case two
    complex conjugate pairs of the matrix's eigenvalues and the pencil its
    four smallest."""
    import scipy.linalg as sla

    w8 = np.linalg.eigvalsh(MATS["lap8"].to_dense())[::-1][:3]
    assert abs(w8[1] - w8[2]) < 1e-12
    np.testing.assert_allclose(jax_result("sym-LM-nb2").eigenvalues, w8,
                               rtol=1e-9)
    w16 = np.linalg.eigvalsh(MATS["lap16"].to_dense())[:3]
    np.testing.assert_allclose(jax_result("sym-SR").eigenvalues, w16,
                               rtol=1e-9)
    # each nonsymmetric Ritz value is an eigenvalue of the matrix; the
    # reference's run converges to the two pairs and passes over the real
    # eigenvalue 16.44 of larger modulus (a non-normal matrix and one
    # start vector), and the port follows it
    ev = jax_result("nonsym-LM").eigenvalues
    wr = np.linalg.eigvals(MATS["recirc"].to_dense())
    assert (np.abs(ev.imag) > 1e-3).all()
    assert max(np.abs(wr - e).min() / abs(e) for e in ev) <= 1e-9
    assert np.abs(wr).max() > np.abs(ev).max() + 0.05
    wm = sla.eigh(K_FE.to_dense(), M_FE.to_dense(), eigvals_only=True)[:4]
    np.testing.assert_allclose(np.sort(jax_result("mass-SM").eigenvalues),
                               wm, rtol=1e-7)


@pytest.mark.parametrize("which", ["LM", "SM", "LR", "SR"])
def test_ordschur_matches_reference(which):
    h = np.random.default_rng(9).standard_normal((12, 12))
    for got, want in zip(_ordschur(h, which, 5), j_ordschur(h, which, 5)):
        np.testing.assert_array_equal(got, want)


def test_select_expansion_columns_matches_reference():
    """Healthy, short, basis-coupled and correlated columns."""
    b = np.eye(5)
    b[3, 3] = 0.1  # M-norm² below 0.25
    b[0, 4] = b[4, 0] = 0.5  # correlated with column 0
    cmax = np.array([0.0, 1e-4, 0.5, 0.0, 0.0])  # column 2 leans on S
    got, want = _select_expansion_columns(b, cmax), j_select(b, cmax)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], [0, 1])


@pytest.mark.parametrize("complex_z", [False, True])
def test_device_ritz_vectors_match_host_product(complex_z):
    """V_m z formed on the device (real and imaginary parts) against the
    reference's host product and column scaling, to 1e-12."""
    rng = np.random.default_rng(10)
    v = rng.standard_normal((300, 12))
    z = rng.standard_normal((12, 4))
    if complex_z:
        z = z + 1j * rng.standard_normal((12, 4))
    want = v @ z
    want = want / np.linalg.norm(want, axis=0, keepdims=True)
    got = _ritz_vectors(SerialComm(), torch.from_numpy(v), z).numpy()
    assert np.iscomplexobj(got) == complex_z
    assert np.abs(got - want).max() <= 1e-12
