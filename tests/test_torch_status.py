"""The port's status tests and residual history against the JAX package's.

Twins of ``tests/test_status.py`` on GMRES (the port's ``cg`` does not take
``stop``/``history`` yet and says so): a max-iterations stop, a loose
composable resnorm stop, OR combos and ``standard_stop`` give the JAX
package's iteration counts and x (1e-9); the multivector history has the
(maxiter + restart + 1, k) shape, ‖b‖ first and the JAX trace's values
(1e-9 of its largest) and NaN pattern. The test functions themselves are
compared on the same states. f64.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trilinos_tpu.galeri import laplace2d
from trilinos_tpu.ops import formats as JF
from trilinos_tpu.ops import matvec as JS
from trilinos_tpu.solvers import gmres as j_gmres
from trilinos_tpu.solvers import status as jstatus

from trilinos_tpu_torch.ops import formats as TF
from trilinos_tpu_torch.ops import matvec as TS
from trilinos_tpu_torch.solvers import cg as t_cg
from trilinos_tpu_torch.solvers import gmres as t_gmres
from trilinos_tpu_torch.solvers import status as tstatus
from trilinos_tpu_torch.solvers.linear_problem import LinearProblem

A = laplace2d(16, 16)
JA = JF.csr_to_ell(A)
TA = TF.csr_to_ell(TF.CsrHost(A.row_ptr, A.cols, A.vals, A.shape),
                   device="cpu")


def jop(x):
    return JS.spmv(JA, x, impl="xla")


def top(x):
    return TS.spmv(TA, x)


def both(b, **kw):
    jr = j_gmres(jop, jnp.asarray(b), **{k: v[0] if isinstance(v, tuple)
                                         else v for k, v in kw.items()})
    tr = t_gmres(top, torch.from_numpy(b), **{
        k: v[1] if isinstance(v, tuple) else v for k, v in kw.items()})
    assert tr.iters == int(jr.iters)
    jx = np.asarray(jr.x)
    assert np.abs(tr.x.numpy() - jx).max() <= 1e-9 * np.abs(jx).max()
    np.testing.assert_array_equal(tr.converged.numpy(),
                                  np.asarray(jr.converged))
    return jr, tr


@pytest.mark.parametrize("case", ["max_iters", "loose_resnorm", "combo_or",
                                  "standard", "nan_or_and"])
def test_stop_tests_match_jax(rng, case):
    b = rng.standard_normal(A.shape[0])
    kw = dict(rtol=1e-12, restart=40, maxiter=200)
    if case == "max_iters":
        st = (jstatus.max_iters(5), tstatus.max_iters(5))
    elif case == "loose_resnorm":
        st = (jstatus.res_norm(1e-2), tstatus.res_norm(1e-2))
    elif case == "combo_or":
        st = tuple(m.combo_or([m.max_iters(3), m.res_norm(1e-30)])
                   for m in (jstatus, tstatus))
    elif case == "standard":
        kw = dict(rtol=1e-8, restart=40, maxiter=400)
        st = (jstatus.standard_stop(1e-8, 0.0, 400),
              tstatus.standard_stop(1e-8, 0.0, 400))
    else:
        st = tuple(m.combo_and([m.combo_or([m.nan_check(),
                                            m.res_norm(1e-4, 0.0, "none")]),
                                m.max_iters(2)]) for m in (jstatus, tstatus))
    jr, tr = both(b, stop=st, **kw)
    if case == "max_iters":
        assert tr.iters == 5 and not bool(tr.converged)
    if case == "loose_resnorm":
        tight = t_gmres(top, torch.from_numpy(b), **kw)
        assert tr.iters < tight.iters
        assert float(tr.resnorm) <= 1e-2 * np.linalg.norm(b) * 1.5
    if case == "combo_or":
        assert tr.iters == 3


def test_history_multivector_matches_jax(rng):
    b = rng.standard_normal((A.shape[0], 3))
    jr, tr = both(b, rtol=1e-8, restart=30, maxiter=90, history=True)
    h, jh = tr.history.numpy(), np.asarray(jr.history)
    assert h.shape == jh.shape == (121, 3)
    np.testing.assert_allclose(h[0], np.linalg.norm(b, axis=0), rtol=1e-12)
    np.testing.assert_array_equal(np.isnan(h), np.isnan(jh))
    fin = ~np.isnan(jh)
    assert np.abs(h[fin] - jh[fin]).max() <= 1e-9 * np.abs(jh[fin]).max()


def test_status_functions_match_jax():
    res = np.array([1e-3, 2e-9, np.nan, 0.5])
    bn = np.array([1.0, 0.0, 2.0, 4.0])
    for it in (3, 7):
        js = jstatus.SolverState(iters=jnp.asarray(it), resnorm=jnp.asarray(
            res), rhs_norm=jnp.asarray(bn))
        ts = tstatus.SolverState(iters=torch.tensor(it),
                                 resnorm=torch.from_numpy(res),
                                 rhs_norm=torch.from_numpy(bn))
        for make in (lambda m: m.max_iters(5),
                     lambda m: m.res_norm(1e-8, 1e-12),
                     lambda m: m.res_norm(1e-2, 0.0, "none"),
                     lambda m: m.nan_check(),
                     lambda m: m.combo_or([m.nan_check(), m.max_iters(5)]),
                     lambda m: m.combo_and([m.res_norm(1.0), m.max_iters(1)]),
                     lambda m: m.standard_stop(1e-2, 0.0, 5)):
            np.testing.assert_array_equal(
                make(tstatus)(ts).numpy(), np.asarray(make(jstatus)(js)))
    with pytest.raises(ValueError, match="scaling"):
        tstatus.res_norm(1.0, scaling="bogus")(ts)


def test_cg_says_only_the_wiring_is_left(rng):
    b = torch.from_numpy(rng.standard_normal(A.shape[0]))
    for kw in (dict(stop=tstatus.max_iters(5)), dict(history=True),
               dict(condest_window=30), dict(compensated=True)):
        with pytest.raises(NotImplementedError,
                           match="only the cg wiring is left"):
            t_cg(top, b, **kw)


def test_linear_problem_composition(rng):
    d = torch.from_numpy(1.0 / A.diagonal())
    b = torch.from_numpy(rng.standard_normal(A.shape[0]))
    lp = LinearProblem(op=top, b=b, left_prec=lambda v: d * v,
                       right_prec=lambda v: 2 * v).set_problem()
    assert torch.equal(lp.x0, torch.zeros_like(b))
    v = torch.from_numpy(rng.standard_normal(A.shape[0]))
    torch.testing.assert_close(lp.composed_op()(v), d * top(2 * v))
    torch.testing.assert_close(lp.composed_rhs(), d * b)
    torch.testing.assert_close(lp.recover_solution(v), 2 * v)
    torch.testing.assert_close(lp.residual(v), b - top(v))
