"""The port's LOBPCG, its Rayleigh-Ritz and the power method against the
JAX package's.

On Galeri ``laplace2d`` 16 × 8 and a Dirichlet-interior P1 stiffness/mass
pencil on the JAX package's smallest test mesh (a 9 × 9 triangulated unit
square, 64 interior nodes), both stored as ELL by each package from one
host matrix, the same seeded start blocks go through both packages in
f64: iteration counts equal, eigenvalues to 1e-10, residual norms to
1e-8, eigenvectors by sign-normalized columns (every case's eigenvalues
are simple) to 1e-8. Each JAX solve runs once and is shared by every test
that reads it. The Rayleigh-Ritz step is held on fixed bases, full rank
and rank deficient (a dependent and a zero column), by the kept rank as
well as the values; in f32 the discarded directions' 1e30 push survives.
"""
import functools

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from trilinos_tpu.eigen import lobpcg as j_lobpcg
from trilinos_tpu.eigen import power_method as j_power_method
from trilinos_tpu.eigen.lobpcg import _rayleigh_ritz as j_rayleigh_ritz
from trilinos_tpu.fem.assembly import mass_matrix, stiffness_matrix
from trilinos_tpu.fem.mesh import structured_tri_mesh
from trilinos_tpu.galeri import laplace2d
from trilinos_tpu.ops import formats as JF
from trilinos_tpu.ops import matvec as JS
from trilinos_tpu.parallel.comm import SerialComm as JSerialComm

from trilinos_tpu_torch.eigen import EigenResult, lobpcg, power_method
from trilinos_tpu_torch.eigen.lobpcg import _rayleigh_ritz
from trilinos_tpu_torch.ops import formats as TF
from trilinos_tpu_torch.ops import matvec as TS
from trilinos_tpu_torch.parallel.comm import SerialComm
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


def fe_pencil():
    """Dirichlet-interior P1 stiffness and mass on a 9 × 9 triangulated
    unit square (the JAX package's generalized-eigenproblem test pencil),
    as JAX CsrHost matrices."""
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


LAP = ell_pair(laplace2d(16, 8))
K_FE, M_FE = fe_pencil()
KOPS, MOPS = ell_pair(K_FE), ell_pair(M_FE)


def start(npad, width, seed):
    return np.random.default_rng(seed).standard_normal((npad, width))


CASES = {  # name: (ops, mass ops or None, start block, keywords)
    "SM": (LAP, None, start(LAP[2], 3, 3), dict(tol=1e-9, maxiter=300)),
    "LM": (LAP, None, start(LAP[2], 2, 4),
           dict(which="LM", tol=1e-9, maxiter=300)),
    "SM-prec": (LAP, None, start(LAP[2], 3, 3),
                dict(tol=1e-9, maxiter=300, prec=0.25)),
    "SM-mass": (KOPS, MOPS, start(KOPS[2], 4, 5),
                dict(tol=1e-9, maxiter=300)),
}


def _run(case, jax_side):
    (jop, top, _), mops, x0, kw = CASES[case]
    kw = dict(kw)
    if "prec" in kw:
        c = kw.pop("prec")
        kw["prec"] = lambda v: c * v
    if jax_side:
        return j_lobpcg(jop, jnp.asarray(x0),
                        m=mops[0] if mops else None, **kw)
    return lobpcg(top, torch.from_numpy(x0), m=mops[1] if mops else None,
                  **kw)


@functools.lru_cache(maxsize=None)
def jax_result(case):
    return _run(case, True)


def aligned_gap(x, y):
    """max |Δ| between the columns of x (reference) and y, each scaled by
    the phase of the reference's largest entry."""
    x, y = np.asarray(x), np.asarray(y)
    i = np.argmax(np.abs(x), axis=0)
    cols = np.arange(x.shape[1])
    px = x[i, cols] / np.abs(x[i, cols])
    py = y[i, cols] / np.abs(y[i, cols])
    return np.abs(x / px - y / py).max()


@pytest.mark.parametrize("case", list(CASES))
def test_lobpcg_matches_jax(case):
    jr, tr = jax_result(case), _run(case, False)
    assert isinstance(tr, EigenResult) and isinstance(tr.iters, int)
    assert tr.iters == int(jr.iters) < CASES[case][3]["maxiter"]
    jv = np.asarray(jr.eigenvalues)
    np.testing.assert_allclose(tr.eigenvalues.numpy(), jv, rtol=EIG_RTOL)
    assert (np.diff(np.sort(jv)) > 1e-3 * np.abs(jv).max()).all()  # simple
    np.testing.assert_allclose(tr.resnorms.numpy(), np.asarray(jr.resnorms),
                               rtol=0, atol=RES_ATOL)
    assert (tr.resnorms.numpy() <= CASES[case][3]["tol"]).all()
    assert aligned_gap(jr.eigenvectors, tr.eigenvectors.numpy()) <= VEC_TOL


def test_lobpcg_finds_the_extreme_pairs():
    """The SM and LM runs find the matrix's own extreme eigenvalues and
    the mass run the pencil's."""
    a = laplace2d(16, 8).to_dense()
    w = np.linalg.eigvalsh(a)
    np.testing.assert_allclose(_run("SM", False).eigenvalues.numpy(), w[:3],
                               rtol=1e-9)
    np.testing.assert_allclose(_run("LM", False).eigenvalues.numpy(),
                               w[::-1][:2], rtol=1e-9)
    import scipy.linalg as sla

    wm = sla.eigh(K_FE.to_dense(), M_FE.to_dense(), eigvals_only=True)
    np.testing.assert_allclose(_run("SM-mass", False).eigenvalues.numpy(),
                               wm[:4], rtol=1e-9)


def spd_and_basis(k_cols, n=40, seed=6):
    rng = np.random.default_rng(seed)
    q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    a = q @ np.diag(np.linspace(0.5, 7.0, n)) @ q.T
    s = rng.standard_normal((n, k_cols))
    mass = np.eye(n) + 0.1 * np.diag(rng.random(n))
    return a, s, mass


@pytest.mark.parametrize("deficient", [False, True])
@pytest.mark.parametrize("with_mass", [False, True])
def test_rayleigh_ritz_matches_jax(deficient, with_mass):
    """Values, the kept rank (directions not pushed to 1e30) and the Ritz
    subspace S·y against the JAX package's, on a basis with a dependent
    and a zero column or without."""
    a, s, mass = spd_and_basis(6)
    if deficient:
        s[:, 4] = s[:, 0] - 2 * s[:, 1]
        s[:, 5] = 0
    ms = mass @ s if with_mass else None
    k = s.shape[1]
    jt, jy = j_rayleigh_ritz(JSerialComm(), jnp.asarray(s),
                             jnp.asarray(a @ s), k,
                             None if ms is None else jnp.asarray(ms))
    tt, ty = _rayleigh_ritz(SerialComm(), torch.from_numpy(s),
                            torch.from_numpy(a @ s), k,
                            None if ms is None else torch.from_numpy(ms))
    jt, tt = np.asarray(jt), tt.numpy()
    kept = int((jt < 1e29).sum())
    assert kept == (4 if deficient else 6) == int((tt < 1e29).sum())
    np.testing.assert_allclose(tt[:kept], jt[:kept], rtol=1e-12)
    assert aligned_gap(s @ np.asarray(jy)[:, :kept],
                       s @ ty.numpy()[:, :kept]) <= 1e-10


def test_rayleigh_ritz_push_survives_float32():
    """In f32 the discarded directions come out at ≈1e30, finite, after
    every kept one, and the kept values match the f64 solve's."""
    a, s, _ = spd_and_basis(6)
    s[:, 5] = 0
    t32, y32 = _rayleigh_ritz(SerialComm(), torch.from_numpy(s).float(),
                              torch.from_numpy(a @ s).float(), 6)
    t64, _ = _rayleigh_ritz(SerialComm(), torch.from_numpy(s),
                            torch.from_numpy(a @ s), 6)
    assert t32.dtype == torch.float32 and torch.isfinite(t32).all()
    assert torch.isfinite(y32).all()
    assert float(t32[4]) < 10 and float(t32[5]) > 1e29
    np.testing.assert_allclose(t32[:5].numpy(), t64[:5].numpy(), rtol=1e-4)


def test_power_method_matches_jax():
    jop, top, n = LAP
    v0 = start(n, 1, 8)[:, 0]
    jlam, jv, jk = j_power_method(jop, jnp.asarray(v0), maxiter=800,
                                  tol=1e-10)
    lam, v, k = power_method(top, torch.from_numpy(v0), maxiter=800,
                             tol=1e-10)
    assert k == int(jk) and 0 < k < 800
    assert abs(float(lam) - float(jlam)) <= 1e-12 * float(jlam)
    assert aligned_gap(np.asarray(jv)[:, None], v.numpy()[:, None]) <= 1e-10
    w = np.linalg.eigvalsh(laplace2d(16, 8).to_dense())
    assert abs(float(lam) - w[-1]) / w[-1] < 1e-4
