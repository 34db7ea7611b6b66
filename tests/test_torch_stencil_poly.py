"""Port parity: the stencil polynomial and the Chebyshev AMG smoother.

The plain versions of the port's ``stencil_poly_apply`` and
``stencil_powers_apply`` must equal the JAX package's XLA references to
the bit in f64 (same term order, same skipped zero coefficients) on
Chebyshev, Richardson, monomial and Newton-pair stages, with pad rows,
with z bounds and on a 2-D grid; one case each is held to 1e-6 against the
Pallas kernel in interpret mode (f32, whose TPU kernel masks by plane
tables and so sums in another order). The stage builders must agree float
for float. The Chebyshev AMG smoother built on it is held against the JAX
package in ``test_torch_cheb_amg.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trilinos_tpu.ops.pallas import stencil_poly as jp
from trilinos_tpu.ops.pallas.stencil_op import StencilOp as JStencilOp
from trilinos_tpu.precond.chebyshev import (
    fused_stencil_chebyshev as j_fused_cheb)
from trilinos_tpu.solvers.sstep_gmres import (
    newton_basis_stages as j_newton_stages)

from trilinos_tpu_torch.galeri import laplace3d
from trilinos_tpu_torch.ops import StencilOp, stencil_poly as tp
from trilinos_tpu_torch.precond import fused_stencil_chebyshev

ST7 = [((0, 0, 0), 6.0), ((1, 0, 0), -1.0), ((-1, 0, 0), -1.0),
       ((0, 1, 0), -1.0), ((0, -1, 0), -1.0), ((0, 0, 1), -1.0),
       ((0, 0, -1), -1.0)]
ST5 = [((0, 0), 4.0), ((1, 0), -1.0), ((-1, 0), -1.0), ((0, 1), -1.0),
       ((0, -1), -1.0)]
# one conjugate pair: the Newton basis fuses it into a quadratic stage
NEWTON = tuple((a, bt, g, 0.0) for a, bt, g in j_newton_stages(
    [5.9, 3.1 + 1.2j, 3.1 - 1.2j, 0.4], 6.0))
STAGES = {
    "chebyshev": jp.chebyshev_stages(1.9, 0.06, 4, 1 / 6.0),
    "richardson": jp.richardson_stages(0.8, 3, 1 / 6.0),
    "monomial": jp.monomial_stages(4, sigma=12.0),
    "newton": NEWTON,
}
GRIDS = {  # dims, stencil, n_rows_pad, z_bounds
    "3d": ((32, 32, 8), ST7, None, None),
    "3d pad rows": ((12, 10, 6), ST7, 2048, None),
    "3d z bounds": ((12, 10, 6), ST7, None, (1, 5)),
    "2d": ((20, 24), ST5, None, None),
}


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def ops(dims, st, npad, dtype):
    return (JStencilOp.create(dims, st, n_rows_pad=npad, dtype=dtype),
            StencilOp.create(dims, st, n_rows_pad=npad, dtype=dtype))


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("kind", STAGES)
def test_plain_matches_xla_bitwise_f64(grid, kind):
    dims, st, npad, zb = GRIDS[grid]
    jop, top = ops(dims, st, npad, "float64")
    x = np.random.default_rng(3).standard_normal(jop.n_rows_pad)
    stages = STAGES[kind]
    want = np.asarray(jp.stencil_powers_xla(jop, stages, jnp.asarray(x),
                                            z_bounds=zb))
    got = tp.stencil_powers_plain(top, stages, torch.from_numpy(x),
                                  z_bounds=zb).numpy()
    np.testing.assert_array_equal(got, want)
    last = tp.stencil_poly_plain(top, stages, torch.from_numpy(x),
                                 z_bounds=zb).numpy()
    np.testing.assert_array_equal(last, want[-1])
    # the wrappers run the plain versions on the CPU
    np.testing.assert_array_equal(tp.stencil_powers_apply(
        top, stages, torch.from_numpy(x), z_bounds=zb).numpy(), want)
    np.testing.assert_array_equal(tp.stencil_poly_apply(
        top, stages, torch.from_numpy(x), z_bounds=zb).numpy(), want[-1])
    if top.n_rows_pad > top.n_rows:  # pad rows carry x through every stage
        np.testing.assert_array_equal(got[:, top.n_rows:],
                                      np.broadcast_to(x[top.n_rows:],
                                                      got[:, top.n_rows:]
                                                      .shape))


@pytest.mark.parametrize("fn", ["poly", "powers"])
def test_plain_matches_pallas_interpret_f32(fn):
    jop, top = ops((32, 32, 8), ST7, None, "float32")
    x = np.random.default_rng(4).standard_normal(jop.n_rows_pad).astype(
        np.float32)
    stages = STAGES["chebyshev" if fn == "poly" else "newton"]
    j_fn = getattr(jp, f"stencil_{fn}_apply")
    t_fn = getattr(tp, f"stencil_{fn}_apply")
    want = np.asarray(j_fn(jop, stages, jnp.asarray(x), interpret=True))
    got = t_fn(top, stages, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert rel(got, want) <= 1e-6


def test_stage_builders_match_jax():
    assert tp.chebyshev_stages(1.9, 0.06, 5, 1 / 6.0) == \
        jp.chebyshev_stages(1.9, 0.06, 5, 1 / 6.0)
    assert tp.richardson_stages(0.8, 4, 0.25) == \
        jp.richardson_stages(0.8, 4, 0.25)
    assert tp.monomial_stages(4, 12.0) == jp.monomial_stages(4, 12.0)
    assert tp.power_stages(3) == jp.power_stages(3)
    jop, top = ops((16, 16, 4), ST7, None, "float64")
    assert tp.stencil_chebyshev_setup(top, 3, lmax=2.0) == \
        jp.stencil_chebyshev_setup(jop, 3, lmax=2.0)
    # λmax by the float32 power method: equal up to f32 rounding
    got = tp.stencil_chebyshev_setup(top, 3, device="cpu")
    want = jp.stencil_chebyshev_setup(jop, 3)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6)


def test_fused_stencil_chebyshev_matches_jax():
    jop, top = ops((16, 16, 4), ST7, 2048, "float64")
    b = np.zeros(jop.n_rows_pad)
    b[:jop.n_rows] = np.random.default_rng(9).standard_normal(jop.n_rows)
    want = np.asarray(j_fused_cheb(jop, 4)(jnp.asarray(b)))
    got = fused_stencil_chebyshev(top, 4, device="cpu")(
        torch.from_numpy(b)).numpy()
    assert rel(got, want) <= 1e-6
    with pytest.raises(TypeError, match="StencilOp"):
        fused_stencil_chebyshev(laplace3d(4, 4, 4), 2, lmax=2.0)


def test_error_paths():
    top = StencilOp.create((8, 8, 4), ST7)
    x = torch.zeros(top.n_rows_pad)
    with pytest.raises(ValueError, match="gamma_1"):
        tp.stencil_poly_apply(top, [(1.0, 0.0, 0.5, 0.0)], x)
    with pytest.raises(ValueError, match="1..8 stages"):
        tp.stencil_powers_apply(top, tp.power_stages(9), x)
    with pytest.raises(ValueError, match="1..8 stages"):
        tp.stencil_poly_apply(top, (), x)
    with pytest.raises(ValueError, match="z_bounds"):
        tp.stencil_poly_apply(top, tp.power_stages(2), x, z_bounds=(0, 5))
    with pytest.raises(ValueError, match="shape"):
        tp.stencil_poly_apply(top, tp.power_stages(2), x[:-1])
    assert tp.stencil_poly_apply.launches == 0
    assert tp.stencil_powers_apply.launches == 0


@pytest.mark.parametrize("powers", [False, True])
def test_counters_count_applies_and_stage_launches(monkeypatch, powers):
    """Where the kernel launches (here its launcher stands in with the
    plain version), each apply adds 1 to ``.launches`` and its plan's
    fused launches to ``.kernel_launches``: one for every chain that fits
    one launch (no longer one a stage), more where the plan splits it
    (radius 2, s = 8, f64)."""
    top = StencilOp.create((8, 8, 4), ST7)
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(
        top.n_rows_pad))
    fn = tp.stencil_powers_apply if powers else tp.stencil_poly_apply
    plain = tp.stencil_powers_plain if powers else tp.stencil_poly_plain
    monkeypatch.setattr(tp, "use_kernel", lambda t: True)
    monkeypatch.setattr(tp, "_launch", lambda op, st, v, zb, all_outputs,
                        plan: (tp.stencil_powers_plain if all_outputs
                               else tp.stencil_poly_plain)(op, st, v, zb))
    monkeypatch.setattr(fn, "launches", 0)
    monkeypatch.setattr(fn, "kernel_launches", 0)
    for stages in (STAGES["chebyshev"], tp.power_stages(2)):
        torch.testing.assert_close(fn(top, stages, x), plain(top, stages, x),
                                   rtol=0, atol=0)
    assert fn.launches == 2
    assert fn.kernel_launches == 2
    wide = StencilOp.create((8, 8, 4), ST7 + [((2, 0, 0), 0.5),
                                              ((0, -2, 0), 0.25),
                                              ((0, 0, 2), 0.125)])
    x8 = torch.from_numpy(np.random.default_rng(12).standard_normal(
        wide.n_rows_pad))
    torch.testing.assert_close(fn(wide, tp.power_stages(8), x8),
                               plain(wide, tp.power_stages(8), x8),
                               rtol=0, atol=0)
    split = len(tp.stencil_poly_plan(wide, tp.power_stages(8), 8).launches)
    assert split > 1
    assert fn.launches == 3
    assert fn.kernel_launches == 2 + split
