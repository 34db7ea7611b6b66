"""Port parity: the derivative rules of the kernel wrappers
(``ops/autodiff.py``) against JAX's differentiation of the JAX package's
XLA applies (``spmv(impl="xla")``), float64 on the CPU.

On the CPU each wrapper's forward runs its plain version inside the
``LinearApply`` Function, so ``torch.func`` reaches the Function's own
``jvp`` and ``backward`` (``LinearApply.jvp_calls`` and ``backward_calls``
count them), not torch's differentiation of the plain code. For a stencil
(the Galeri 7-point cross and a nonsymmetric 27-point stencil), a
nonsymmetric stored DIA matrix (Galeri ``recirc2d``) and a random
nonsymmetric BDIA matrix (b = 3), in single-vector and k = 3 multivector
form: the JVP tangent is the wrapper applied to the tangent (bitwise) and
``jax.jvp``'s to 1e-13, the VJP cotangent is the transpose apply and
``jax.vjp``'s to 1e-13, and the forward-over-reverse Hessian-vector
product of ½xᵀAx is ½(A + Aᵀ)v and JAX's to 1e-13. Forward mode through
``torch.autograd.forward_ad`` reaches the same rule, and an apply with
nothing to differentiate skips the Function. Tolerances are max|Δ| /
max|y|.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from torch_threads import one_thread  # noqa: F401  (autouse)
from trilinos_tpu.galeri import laplace3d as j_laplace3d
from trilinos_tpu.galeri import recirc2d as j_recirc2d
from trilinos_tpu.ops import formats as jF
from trilinos_tpu.ops import matvec as jmv
from trilinos_tpu.ops.pallas.stencil_op import StencilOp as JStencilOp
from trilinos_tpu_torch.galeri import laplace3d, recirc2d
from trilinos_tpu_torch.ops import (CsrHost, StencilOp, bdia_spmm,
                                    bdia_spmv, bdia_spmv_t_plain, csr_to_bdia,
                                    csr_to_dia, dia_spmm, dia_spmv,
                                    dia_spmv_t_plain, pack_planes,
                                    stencil_spmm, stencil_spmv, unpack_planes)
from trilinos_tpu_torch.ops.autodiff import LinearApply, differentiating

TOL = 1e-13
K = 3


def rel(got, want):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _stencil27(rng):
    """A nonsymmetric 27-point stencil with random coefficients."""
    offs = [(dx, dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
            for dx in (-1, 0, 1)]
    return [(o, float(c)) for o, c in zip(offs, rng.standard_normal(27))]


def _block_coo(rng, nb=40, b=3, offsets=(-7, -1, 0, 2, 5)):
    rows, cols, vals = [], [], []
    for o in offsets:
        qs = np.arange(max(0, -o), min(nb, nb - o))
        blocks = rng.standard_normal((len(qs), b, b))
        for bi in range(b):
            for bj in range(b):
                rows.append(qs * b + bi)
                cols.append((qs + o) * b + bj)
                vals.append(blocks[:, bi, bj])
    return (np.concatenate(rows), np.concatenate(cols), np.concatenate(vals),
            (nb * b, nb * b))


@functools.lru_cache(maxsize=None)
def operators():
    """name -> (JAX matrix, port matrix, port wrapper of one vector, of k,
    port transpose)."""
    rng = np.random.default_rng(3)
    st27 = _stencil27(rng)
    coo = _block_coo(rng)
    jb = jF.csr_to_bdia(jF.CsrHost.from_coo(*coo), 3)
    tb = csr_to_bdia(CsrHost.from_coo(*coo), 3, device="cpu")
    jr, tr = j_recirc2d(9, 7), recirc2d(9, 7)
    t_lap = laplace3d(6, 5, 4, fmt="stencil", dtype=np.float64)
    t27 = StencilOp.create((5, 4, 3), st27, dtype="float64")
    return {
        "stencil7": (j_laplace3d(6, 5, 4, fmt="stencil", dtype=np.float64),
                     t_lap, stencil_spmv, stencil_spmm,
                     lambda a, x: stencil_spmv(a.transposed(), x)),
        "stencil27": (JStencilOp.create((5, 4, 3), st27, dtype="float64"),
                      t27, stencil_spmv, stencil_spmm,
                      lambda a, x: stencil_spmv(a.transposed(), x)),
        "dia": (jF.csr_to_dia(jr), csr_to_dia(tr, device="cpu"), dia_spmv,
                dia_spmm, dia_spmv_t_plain),
        "bdia": (jb, tb, bdia_spmv, bdia_spmm, bdia_spmv_t_plain),
    }


NAMES = ["stencil7", "stencil27", "dia", "bdia"]


def _vectors(a, k, seed):
    """Seeded x, v and w (n_pad,) or (n_pad, k), zero in the pad rows."""
    rng = np.random.default_rng(seed)
    shape = (a.n_rows_pad,) + ((k,) if k else ())
    out = []
    for _ in range(3):
        x = np.zeros(shape)
        x[:a.n_rows] = rng.standard_normal((a.n_rows,) + shape[1:])
        out.append(x)
    return out


def _jax_apply(ja):
    return lambda x: jmv.spmv(ja, x, impl="xla")


@pytest.mark.parametrize("k", [0, K])
@pytest.mark.parametrize("name", NAMES)
def test_jvp_rule(name, k):
    ja, ta, one, many, _ = operators()[name]
    wrap = many if k else one
    x, v, _ = _vectors(ta, k, 11)
    calls = LinearApply.jvp_calls
    y, t = torch.func.jvp(lambda z: wrap(ta, z), (torch.from_numpy(x),),
                          (torch.from_numpy(v),))
    assert LinearApply.jvp_calls == calls + 1
    # the rule is the wrapper applied to the tangent, to the bit
    assert torch.equal(t, wrap(ta, torch.from_numpy(v)))
    jy, jt = jax.jvp(_jax_apply(ja), (jnp.asarray(x),), (jnp.asarray(v),))
    assert rel(y, jy) <= TOL
    assert rel(t, jt) <= TOL


@pytest.mark.parametrize("k", [0, K])
@pytest.mark.parametrize("name", NAMES)
def test_vjp_rule(name, k):
    ja, ta, one, many, trans = operators()[name]
    wrap = many if k else one
    x, _, w = _vectors(ta, k, 12)
    calls = LinearApply.backward_calls
    _, pull = torch.func.vjp(lambda z: wrap(ta, z), torch.from_numpy(x))
    g = pull(torch.from_numpy(w))[0]
    assert LinearApply.backward_calls == calls + 1
    assert torch.equal(g, trans(ta, torch.from_numpy(w)))
    _, jpull = jax.vjp(_jax_apply(ja), jnp.asarray(x))
    assert rel(g, jpull(jnp.asarray(w))[0]) <= TOL
    # the same rule through ordinary autograd, with a cotangent that is
    # not contiguous (the rule makes it so before the apply)
    xr = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(np.asfortranarray(w)) if k else torch.from_numpy(w)
    (wrap(ta, xr) * wt).sum().backward()
    assert rel(xr.grad, jpull(jnp.asarray(w))[0]) <= TOL


@pytest.mark.parametrize("name", NAMES)
def test_forward_over_reverse_hvp(name):
    """The optim layer's Hessian-vector product: jvp of grad of ½xᵀAx
    runs the backward rule under a JVP, so both rules run."""
    ja, ta, one, _, trans = operators()[name]
    x, v, _ = _vectors(ta, 0, 13)
    xt, vt = torch.from_numpy(x), torch.from_numpy(v)

    def q(z):
        return 0.5 * torch.dot(z, one(ta, z))

    jvps, bwds = LinearApply.jvp_calls, LinearApply.backward_calls
    hv = torch.func.jvp(torch.func.grad(q), (xt,), (vt,))[1]
    assert LinearApply.backward_calls == bwds + 1
    assert LinearApply.jvp_calls == jvps + 2  # the forward and its transpose
    want = 0.5 * (one(ta, vt) + trans(ta, vt))
    assert rel(hv, want) <= TOL
    jq = lambda z: 0.5 * jnp.dot(z, _jax_apply(ja)(z))
    jhv = jax.jvp(jax.grad(jq), (jnp.asarray(x),), (jnp.asarray(v),))[1]
    assert rel(hv, jhv) <= TOL


def test_bdia_planes_rules():
    """bdia_spmm in plane layout: JVP is the plane apply, VJP the plane
    transpose (the interleaved transpose between unpack and pack)."""
    _, ta, _, _, _ = operators()["bdia"]
    x, v, w = _vectors(ta, K, 14)
    xp, vp, wp = (pack_planes(ta, torch.from_numpy(a)) for a in (x, v, w))
    y, t = torch.func.jvp(lambda z: bdia_spmm(ta, z, layout="planes"),
                          (xp,), (vp,))
    assert torch.equal(t, bdia_spmm(ta, vp, layout="planes"))
    assert rel(unpack_planes(ta, y), bdia_spmv(ta, torch.from_numpy(x))) \
        <= TOL
    _, pull = torch.func.vjp(lambda z: bdia_spmm(ta, z, layout="planes"), xp)
    want = bdia_spmv_t_plain(ta, torch.from_numpy(w))
    assert rel(unpack_planes(ta, pull(wp)[0]), want) <= TOL


def test_matrix_values_must_not_require_grad():
    _, ta, *_ = operators()["dia"]
    x = torch.zeros(ta.n_rows_pad, dtype=torch.float64)
    data = ta.data.clone().requires_grad_()
    with pytest.raises(ValueError, match="require grad"):
        dia_spmv(dataclasses.replace(ta, data=data), x)


@pytest.mark.parametrize("name", NAMES)
def test_forward_mode_dual_rule(name):
    """torch.autograd.forward_ad (a dual level, no torch.func transform)
    reaches the same jvp rule."""
    _, ta, one, _, _ = operators()[name]
    x, v, _ = _vectors(ta, 0, 16)
    xt, vt = torch.from_numpy(x), torch.from_numpy(v)
    calls = LinearApply.jvp_calls
    with fwAD.dual_level():
        tan = fwAD.unpack_dual(one(ta, fwAD.make_dual(xt, vt))).tangent
    assert LinearApply.jvp_calls == calls + 1
    assert torch.equal(tan, one(ta, vt))


def test_applies_outside_any_derivative_skip_the_function():
    """With nothing to differentiate an apply calls the forward directly
    (the Function's host bookkeeping is skipped); under every way of
    differentiating it goes through the Function."""
    x = torch.zeros(4, dtype=torch.float64)
    assert not differentiating(x)
    assert differentiating(x.clone().requires_grad_())
    with torch.no_grad():
        assert not differentiating(x.clone().requires_grad_())
    with fwAD.dual_level():
        assert differentiating(x)
    seen = []
    torch.func.jvp(lambda z: (seen.append(differentiating(z)), z)[1], (x,),
                   (x,))
    assert seen == [True]


def test_cpu_rules_launch_nothing():
    """On the CPU the rules run the plain versions: no launch counter
    moves."""
    _, ta, one, _, _ = operators()["stencil7"]
    before = stencil_spmv.launches
    x, v, _ = _vectors(ta, 0, 15)
    torch.func.jvp(lambda z: one(ta, z), (torch.from_numpy(x),),
                   (torch.from_numpy(v),))
    assert stencil_spmv.launches == before == 0
