"""The port's eigensolver factory, TraceMin, RTR, shift-invert and
``eigen_entry`` against the JAX package's.

The factory's alias, parameter and "Which" tables equal the reference's
key for key, and every name solves through ``create_eigensolver(name)
.solve(EigenProblem(...))`` on Galeri ``laplace2d`` 16 × 8 (ELL, no pad
rows) to the matrix's own eigenvalues, giving what the kind's function
gives when called with the factory's arguments. Through both packages'
factories, with the start blocks each kind draws itself (the same seeded
host arrays), TraceMin and RTR (nev 2): iteration counts equal,
eigenvalues to 1e-10, residual norms to 1e-8, eigenvectors by subspace to
1e-8, each pair's true residual. Shift-invert: one apply (MINRES, the
same iteration count) and ``eigs_near`` between two eigenvalues.

``eigen_entry`` at 8³ (512 rows in 1024, pad rows zero in the start
block): LOBPCG SR, nev 4, with the structured AMG V-cycle (the JAX
package's hierarchy of the same stencil) and without. Three of the four
wanted eigenvalues are one triple eigenvalue: how the residual spreads
over a degenerate cluster's vectors follows rounding, so the test's ``any
residual > tol`` can pass one iteration apart (64 and 65 iterations
unpreconditioned; 17 in the JAX package with the V-cycle, one more or
less in the port as its reductions' order changes with the thread
count). Both runs are held to ±1 iteration there, the eigenvalues to
1e-10 and the cluster's subspace to 1e-8. On the CPU no kernel is
launched, and without a card ``eigen_entry()`` raises.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trilinos_tpu.eigen import EigenProblem as JEigenProblem
from trilinos_tpu.eigen import create_eigensolver as j_create
from trilinos_tpu.eigen import eigs_near as j_eigs_near
from trilinos_tpu.eigen import factory as j_factory
from trilinos_tpu.galeri import laplace2d
from trilinos_tpu.galeri import laplace3d as j_laplace3d
from trilinos_tpu.ops import formats as JF
from trilinos_tpu.ops import matvec as JS
from trilinos_tpu.ops import spmv as j_spmv
from trilinos_tpu.precond import SaAmg as JSaAmg
from trilinos_tpu.solvers import minres as j_minres

from trilinos_tpu_torch import eigen
from trilinos_tpu_torch.eigen import (EigenProblem, create_eigensolver,
                                      eigensolver_names, eigs_near,
                                      shift_invert)
from trilinos_tpu_torch.eigen import factory
from trilinos_tpu_torch.entry import eigen_entry
from trilinos_tpu_torch.galeri import laplace3d
from trilinos_tpu_torch.ops import (chol_inv_small, dia_spmm, dia_spmv,
                                    stencil_spmm, stencil_spmv)
from trilinos_tpu_torch.ops import formats as TF
from trilinos_tpu_torch.ops import matvec as TS
from trilinos_tpu_torch.precond import SaAmg
from trilinos_tpu_torch.solvers import minres
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


LAP = laplace2d(16, 8)
W_LAP = np.linalg.eigvalsh(LAP.to_dense())
OPS = {"lap": ell_pair(LAP)}


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


def as_np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# -- the tables ------------------------------------------------------------

def test_tables_equal_the_reference():
    assert factory.ALIASES == j_factory.ALIASES
    assert eigensolver_names() == j_factory.eigensolver_names()
    assert factory._SYM_WHICH == j_factory._SYM_WHICH
    assert factory._LOBPCG_WHICH == j_factory._LOBPCG_WHICH
    assert list(factory._SPECS) == list(j_factory._SPECS)
    for key, spec in factory._SPECS.items():
        ref = j_factory._SPECS[key]
        assert (spec.name, spec.default, spec.choices, spec.doc) == (
            ref.name, ref.default, ref.choices, ref.doc)
    assert EigenProblem(op=None, n=1, nev=1).dtype == torch.float64
    assert eigen.__all__ == __import__("trilinos_tpu.eigen",
                                       fromlist=["x"]).__all__


def test_unknown_name_and_bad_which():
    with pytest.raises(ValueError, match="unknown eigensolver"):
        create_eigensolver("NOT A SOLVER")
    with pytest.raises(ValueError):
        create_eigensolver("LOBPCG", {"Which": "XX"})


# -- every name through the port's factory ---------------------------------

NAME_PARAMS = {  # kind: (params, nev, wanted eigenvalues)
    "bks": ({"Which": "LM", "Convergence Tolerance": 1e-9}, 3,
            W_LAP[::-1][:3]),
    "lobpcg": ({"Which": "SR", "Convergence Tolerance": 1e-9,
                "Maximum Iterations": 300}, 3, W_LAP[:3]),
    "davidson": ({"Which": "SR", "Convergence Tolerance": 1e-9}, 3,
                 W_LAP[:3]),
    "gen_davidson": ({"Which": "LM", "Convergence Tolerance": 1e-9,
                      "Maximum Iterations": 300}, 2, W_LAP[::-1][:2]),
    "tracemin": ({"Maximum Iterations": 150}, 2, W_LAP[:2]),
    "rtr": ({"Maximum Iterations": 150}, 2, W_LAP[:2]),
    "lanczos": ({"Which": "LA", "Num Blocks": 80}, 2, W_LAP[::-1][:2]),
    "power": ({"Maximum Iterations": 800, "Convergence Tolerance": 1e-10},
              1, W_LAP[::-1][:1]),
}


@functools.lru_cache(maxsize=None)
def port_solve(name):
    params, nev, _ = NAME_PARAMS[factory.ALIASES[name]]
    _, top, n = OPS["lap"]
    return create_eigensolver(name, params).solve(
        EigenProblem(op=top, n=n, nev=nev, device="cpu"))


def values(res):
    lam = res[0] if isinstance(res, tuple) else res.eigenvalues
    return np.atleast_1d(as_np(lam))


@pytest.mark.parametrize("name", eigensolver_names())
def test_every_name_solves_through_the_factory(name):
    kind = factory.ALIASES[name]
    _, nev, want = NAME_PARAMS[kind]
    got = values(port_solve(name))[:nev]
    rtol = 1e-4 if kind == "power" else 1e-7
    np.testing.assert_allclose(np.sort(got.real), np.sort(want), rtol=rtol)


@pytest.mark.parametrize("kind", list(NAME_PARAMS))
def test_factory_passes_the_kind_its_arguments(kind):
    """The factory's solve equals the kind's function called with the
    factory's arguments (the mapped "Which", the start block it draws)."""
    params, nev, _ = NAME_PARAMS[kind]
    name = next(k for k, v in factory.ALIASES.items() if v == kind)
    got = port_solve(name)
    _, top, n = OPS["lap"]
    tol = params.get("Convergence Tolerance", 1e-8)
    maxiter = params.get("Maximum Iterations", 200)
    v7 = lambda *shape: torch.from_numpy(  # noqa: E731
        np.random.default_rng(7).standard_normal(shape))
    if kind == "bks":
        want = eigen.block_krylov_schur(top, n, nev, which="LM", tol=tol,
                                        max_restarts=20, symmetric=True,
                                        device="cpu")
    elif kind == "lobpcg":
        want = eigen.lobpcg(top, v7(n, nev), which="SM", tol=tol,
                            maxiter=maxiter)
    elif kind == "davidson":
        want = eigen.block_davidson(top, n, nev, which="SA", tol=tol,
                                    device="cpu")
    elif kind == "gen_davidson":
        want = eigen.generalized_davidson(top, n, nev, which="LM", tol=tol,
                                          maxiter=maxiter, device="cpu")
    elif kind == "tracemin":
        want = eigen.tracemin(top, n, nev, maxiter=maxiter, device="cpu")
    elif kind == "rtr":
        want = eigen.rtr(top, n, nev, maxiter=maxiter, device="cpu")
    elif kind == "lanczos":
        want = eigen.lanczos_eigs(top, v7(n), nev, m=80, which="LA")
    else:
        want = eigen.power_method(top, v7(n), maxiter=maxiter, tol=tol)
    np.testing.assert_array_equal(values(got), values(want))


@pytest.mark.parametrize("name", ["Lanczos", "POWER"])
def test_mass_rejected_by_standard_only_kinds(name):
    _, top, n = OPS["lap"]
    prob = EigenProblem(op=top, n=n, nev=2, m=lambda v: 2.0 * v,
                        device="cpu")
    with pytest.raises(ValueError, match="mass"):
        create_eigensolver(name).solve(prob)


# -- twins of the two factories --------------------------------------------

TWINS = {  # label: (name, params, nev)
    "TraceMin": ("TraceMin", {"Maximum Iterations": 150}, 2),
    "RTR": ("RTR", {"Maximum Iterations": 150}, 2),
}


def _twin(label, jax_side):
    name, params, nev = TWINS[label]
    jop, top, n = OPS["lap"]
    if jax_side:
        return j_create(name, params).solve(JEigenProblem(op=jop, n=n,
                                                          nev=nev))
    return create_eigensolver(name, params).solve(EigenProblem(
        op=top, n=n, nev=nev, device="cpu"))


@pytest.mark.parametrize("label", list(TWINS))
def test_factory_twin_matches_jax(label):
    jr, tr = _twin(label, True), _twin(label, False)
    assert tr.converged and jr.converged
    assert tr.iters == jr.iters
    jv, tv = np.asarray(jr.eigenvalues), tr.eigenvalues
    np.testing.assert_allclose(tv, jv, rtol=EIG_RTOL)
    np.testing.assert_allclose(tr.resnorms, jr.resnorms, rtol=0,
                               atol=RES_ATOL)
    assert projector_gap(jr.eigenvectors, tr.eigenvectors.numpy(),
                         jv) <= VEC_TOL
    _, top, _ = OPS["lap"]
    r = top(tr.eigenvectors) - tr.eigenvectors * torch.from_numpy(tv)
    assert (torch.linalg.vector_norm(r, dim=0) <= 1e-7).all()


# -- shift-invert -------------------------------------------------------------

SIGMA = 0.5 * (W_LAP[5] + W_LAP[6])  # between two simple eigenvalues


def test_shift_invert_apply_matches_jax_minres():
    """One apply of (A − σI)⁻¹: MINRES takes the reference's iterations
    at the f64 default inner tolerance 1e-10, and x agrees to 1e-10; the
    default inner tolerance is 1e-6 for an f32 vector."""
    jop, top, n = OPS["lap"]
    b = np.random.default_rng(11).standard_normal(n)
    jres = j_minres(lambda v: jop(v) - SIGMA * v, jnp.asarray(b),
                    rtol=1e-10, maxiter=1000)
    res = minres(lambda v: top(v) - SIGMA * v, torch.from_numpy(b),
                 rtol=1e-10, maxiter=1000)
    assert res.iters == int(jres.iters) and bool(res.converged.all())
    x = shift_invert(top, SIGMA)(torch.from_numpy(b))
    np.testing.assert_array_equal(x.numpy(), res.x.numpy())
    assert np.abs(x.numpy() - np.asarray(jres.x)).max() <= (
        1e-10 * np.abs(np.asarray(jres.x)).max())
    seen = []

    def spy(op, v, rtol, maxiter):
        seen.append((v.dtype, rtol, maxiter))
        return res

    for dt in (torch.float64, torch.float32):
        shift_invert(top, SIGMA, solver=spy)(torch.from_numpy(b).to(dt))
    assert seen == [(torch.float64, 1e-10, 1000), (torch.float32, 1e-6, 1000)]


def test_eigs_near_matches_jax():
    jop, top, n = OPS["lap"]
    v0 = np.random.default_rng(12).standard_normal(n)
    jl, jv = j_eigs_near(jop, SIGMA, 2, jnp.asarray(v0), m=40)
    tl, tv = eigs_near(top, SIGMA, 2, torch.from_numpy(v0), m=40)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=EIG_RTOL)
    np.testing.assert_allclose(np.sort(tl.numpy()), W_LAP[5:7], rtol=1e-8)
    assert projector_gap(np.asarray(jv), tv.numpy(), np.asarray(jl)) <= (
        VEC_TOL)


# -- eigen_entry at 8³ --------------------------------------------------------

@functools.lru_cache(maxsize=None)
def hierarchies():
    jop = j_laplace3d(8, 8, 8, dtype=np.float64, fmt="stencil")
    jm = JSaAmg(jop, {"dtype": np.float64}).compute()
    top = laplace3d(8, 8, 8, dtype=np.float64, fmt="stencil")
    tm = SaAmg(top, {"dtype": np.float64, "smoother: type": "jacobi"},
               device="cpu").compute()
    return jop, jm, tm


ENTRY_PARAMS = {"Which": "SR"}


@functools.lru_cache(maxsize=None)
def jax_entry(with_amg, v0):
    jop, jm, _ = hierarchies()
    st = jm.state()
    prec = (lambda v: jm.apply_state(st, v)) if with_amg else None
    return j_create("LOBPCG", ENTRY_PARAMS).solve(JEigenProblem(
        op=lambda v: j_spmv(jop, v), n=jop.n_rows_pad, nev=4, prec=prec,
        v0=np.frombuffer(v0).reshape(jop.n_rows_pad, 4)))


@pytest.mark.parametrize("with_amg,max_diters", [(True, 1), (False, 1)])
def test_eigen_entry_twin_matches_jax(with_amg, max_diters):
    for fn in (stencil_spmv, stencil_spmm, dia_spmv, dia_spmm,
               chol_inv_small):
        fn.launches = 0
    _, _, tm = hierarchies()
    step, (v0, st) = eigen_entry("LOBPCG", ENTRY_PARAMS, dims=(8, 8, 8),
                                 nev=4, device="cpu",
                                 amg=tm if with_amg else None)
    assert v0.shape == (1024, 4) and not v0[512:].any()
    res = step(v0, st)
    jr = jax_entry(with_amg, v0.numpy().tobytes())
    assert abs(res.iters - int(jr.iters)) <= max_diters
    jv = np.asarray(jr.eigenvalues)
    np.testing.assert_allclose(res.eigenvalues.numpy(), jv, rtol=EIG_RTOL)
    assert (res.resnorms <= 1e-8).all()
    assert projector_gap(np.asarray(jr.eigenvectors),
                         res.eigenvectors.numpy(), jv) <= VEC_TOL
    # the closed form of Laplace3D on 8³: 3·s(1) and 2·s(1) + s(2) (×3)
    s = 2 - 2 * np.cos(np.arange(1, 3) * np.pi / 9)
    np.testing.assert_allclose(res.eigenvalues.numpy(),
                               [3 * s[0]] + [2 * s[0] + s[1]] * 3,
                               rtol=1e-9)
    # on the CPU every wrapper ran its plain version: no kernel launched
    for fn in (stencil_spmv, stencil_spmm, dia_spmv, dia_spmm,
               chol_inv_small):
        assert fn.launches == 0
    assert step.manager.kind == "lobpcg" and step.operator.dims == (8, 8, 8)


def test_eigen_entry_start_widths():
    """The start block is as wide as each kind's own default start."""
    for name, params, width in (("BKS", {}, 1), ("BKS", {"Block Size": 2}, 2),
                                ("TraceMin", {}, 6), ("RTR", {}, 4),
                                ("Block Davidson", {}, 4),
                                ("LANCZOS", {}, None), ("POWER", {}, None)):
        _, (v0, st) = eigen_entry(name, params, dims=(4, 4, 4), device="cpu")
        assert st is None
        assert v0.shape == ((1024,) if width is None else (1024, width))
        assert not v0[64:].any()


def test_eigen_entry_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eigen_entry("LOBPCG")
    _, top, n = OPS["lap"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_eigensolver("RTR").solve(EigenProblem(op=top, n=n, nev=2))


def test_eigen_path_keeps_float32_matmuls_exact():
    """The Grams and whitening GEMMs of every kind run under the
    package's TF32-off setting (the reference's ``hi_precision``): an f32
    LOBPCG and an f32 Block Davidson through the factory find the f64
    eigenvalues to f32 rounding."""
    assert torch.get_float32_matmul_precision() == "highest"
    assert not torch.backends.cuda.matmul.allow_tf32
    a32 = TF.csr_to_ell(TF.CsrHost(LAP.row_ptr, LAP.cols, LAP.vals,
                                   LAP.shape), dtype=np.float32,
                        device="cpu")
    for name in ("LOBPCG", "Block Davidson"):
        res = create_eigensolver(name, {"Which": "SR",
                                        "Convergence Tolerance": 1e-4}
                                 ).solve(EigenProblem(
                                     op=lambda v: TS.spmv(a32, v), n=128,
                                     nev=3, dtype=np.float32, device="cpu"))
        assert res.eigenvectors.dtype == torch.float32
        np.testing.assert_allclose(np.sort(as_np(res.eigenvalues)),
                                   W_LAP[:3], rtol=1e-5)
