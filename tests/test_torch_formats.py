"""The port's ELL and BSR formats against the JAX package's.

Twins of ``tests/test_formats.py``: the same host CSR, packed by both
packages, must give the same arrays (padding included: ELL's zero pad
rows, the BSR block-row padding and its identity blocks, zeros in every
pad slot), the same
``choose_format`` choice and ``to_dense``; SpMV/SpMM forward to 1e-13
relative and transpose to 1e-12 (the port's transposes scatter with
``index_add_``, which sums a row's contributions in another order than
JAX's ``.at[].add``). Also the Galeri generators of this slice and the
converters of ``convert.py``. All f64.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trilinos_tpu.galeri import stencils as jst
from trilinos_tpu.ops import formats as JF
from trilinos_tpu.ops import matvec as JS

from trilinos_tpu_torch.convert import bsr_from_numpy, ell_from_numpy
from trilinos_tpu_torch.galeri import stencils as tst
from trilinos_tpu_torch.ops import formats as TF
from trilinos_tpu_torch.ops import matvec as TS
from torch_threads import one_thread  # noqa: F401  (autouse)

FWD_TOL, T_TOL = 1e-13, 1e-12


def random_csr(rng, m, n, density=0.2):
    nnz = max(int(m * n * density), 1)
    return JF.CsrHost.from_coo(rng.integers(0, m, nnz), rng.integers(0, n, nnz),
                               rng.standard_normal(nnz), (m, n))


def port_csr(a):
    return TF.CsrHost(a.row_ptr, a.cols, a.vals, a.shape)


def rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def pack(fmt, a, **kw):
    """(JAX matrix, port matrix) of host CSR a in format ``fmt``."""
    j = {"ell": JF.csr_to_ell, "bsr": JF.csr_to_bsr}[fmt](a, **kw)
    t = {"ell": TF.csr_to_ell, "bsr": TF.csr_to_bsr}[fmt](
        port_csr(a), device="cpu", **kw)
    return j, t


def check_applies(j, t, n_pad, nrhs, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n_pad,) if nrhs == 0 else (n_pad, nrhs))
    for transpose, tol in ((False, FWD_TOL), (True, T_TOL)):
        want = np.asarray(JS.spmv(j, jnp.asarray(x), transpose=transpose,
                                  impl="xla"))
        got = TS.spmv(t, torch.from_numpy(x), transpose=transpose).numpy()
        assert got.shape == want.shape
        assert rel(got, want) <= tol, (transpose, rel(got, want))


ELL_KW = [{}, {"k": 9}, {"n_rows_pad": 48}, {"identity_pad_rows": False},
          {"n_rows_pad": 40, "identity_pad_rows": False, "n_cols": 36}]


@pytest.mark.parametrize("case", ["random", "rect", "empty_rows", "recirc"])
@pytest.mark.parametrize("kw", ELL_KW, ids=["default", "k", "rows", "no-id",
                                           "rectangular"])
def test_ell_pack_arguments_match_jax(rng, case, kw):
    """``csr_to_ell``'s width, padded rows, identity-pad flag and column
    count as the reference takes them: the cases of
    ``test_ell_pack_and_applies`` packed with and without them give the
    reference's arrays, and the defaults give what the argument-less call
    gave (zero pad rows)."""
    a = {"random": lambda: random_csr(rng, 33, 33),
         "rect": lambda: random_csr(rng, 16, 24),
         "empty_rows": lambda: JF.CsrHost.from_coo([2], [1], [3.0], (5, 5)),
         "recirc": lambda: jst.recirc2d(5, 7, diff=1e-2)}[case]()
    if kw.get("k", 0) and kw["k"] < a.max_row_length():
        kw = dict(kw, k=a.max_row_length())
    j, t = pack("ell", a, **kw)
    np.testing.assert_array_equal(t.cols.numpy(), np.asarray(j.cols))
    np.testing.assert_array_equal(t.vals.numpy(), np.asarray(j.vals))
    assert (t.n_rows, t.n_cols, t.nnz, t.k) == (j.n_rows, j.n_cols, j.nnz, j.k)
    plain = TF.csr_to_ell(port_csr(a), device="cpu")
    if not kw:
        np.testing.assert_array_equal(t.cols.numpy(), plain.cols.numpy())
    assert not t.vals.numpy()[a.shape[0]:].any()
    with pytest.raises(ValueError, match="exceeds ELL width"):
        TF.csr_to_ell(port_csr(a), k=a.max_row_length() - 1, device="cpu")


@pytest.mark.parametrize("case", ["random", "rect", "empty_rows", "recirc"])
def test_ell_pack_and_applies(rng, case):
    if case == "random":
        a = random_csr(rng, 33, 33)
    elif case == "rect":
        a = random_csr(rng, 16, 24)
    elif case == "empty_rows":
        a = JF.CsrHost.from_coo([2], [1], [3.0], (5, 5))
    else:
        a = jst.recirc2d(7, 5, diff=1e-2)
    j, t = pack("ell", a)
    np.testing.assert_array_equal(t.cols.numpy(), np.asarray(j.cols))
    np.testing.assert_array_equal(t.vals.numpy(), np.asarray(j.vals))
    assert (t.n_rows, t.n_cols, t.nnz, t.k) == (j.n_rows, j.n_cols, j.nnz, j.k)
    np.testing.assert_array_equal(TF.to_dense(t), JF.to_dense(j))
    if case != "rect":
        for nrhs in (0, 1, 4):
            check_applies(j, t, j.n_rows_pad, nrhs)
    else:
        x = rng.standard_normal(24)
        want = np.asarray(JS.spmv(j, jnp.asarray(x), impl="xla"))
        got = TS.spmv(t, torch.from_numpy(x)).numpy()
        assert rel(got, want) <= FWD_TOL


@pytest.mark.parametrize("b", [1, 2, 4, 8])
@pytest.mark.parametrize("case", ["random", "unaligned", "laplace3d"])
def test_bsr_pack_and_applies(rng, b, case):
    if case == "random":
        a = random_csr(rng, 48, 48, density=0.15)
    elif case == "unaligned":
        a = random_csr(rng, 21, 21, density=0.3)  # padded to a multiple of b
    else:
        a = jst.laplace3d(4, 4, 3)
    j, t = pack("bsr", a, block_size=b)
    # the block-row padding (ROW_ALIGN // b, of 1 for b >= 8) and zeros in
    # every pad slot, as the reference packs them
    assert t.n_brows_pad == j.n_brows_pad
    np.testing.assert_array_equal(t.bcols.numpy(), np.asarray(j.bcols))
    np.testing.assert_array_equal(t.bvals.numpy(), np.asarray(j.bvals))
    assert (t.n_rows, t.n_cols, t.nnz, t.kb) == (j.n_rows, j.n_cols, j.nnz,
                                                 j.kb)
    np.testing.assert_array_equal(TF.to_dense(t), JF.to_dense(j))
    for nrhs in (0, 1, 4):
        check_applies(j, t, j.n_brows_pad * b, nrhs, seed=b)


def test_bsr_refuses_unblockable_shapes(rng):
    with pytest.raises(ValueError, match="divisible"):
        TF.csr_to_bsr(port_csr(random_csr(rng, 6, 9)), 4, device="cpu")


@pytest.mark.parametrize("name", ["stencil", "irregular", "blocked",
                                  "stencil_nrhs", "elasticity"])
def test_choose_format_matches(rng, name):
    if name in ("stencil", "stencil_nrhs"):
        a, kw = jst.laplace2d(10, 10), {}
        if name == "stencil_nrhs":
            kw = dict(nrhs=4)
    elif name == "irregular":
        a, kw = random_csr(rng, 64, 64), dict(nrhs=3)
    elif name == "blocked":
        a, kw = random_csr(rng, 24, 24), dict(block_size=2)
    else:
        from trilinos_tpu.galeri import elasticity2d

        a, kw = elasticity2d(5, 4), dict(block_size=2)
    j = JF.choose_format(a, **kw)
    # the port's choice does not take nrhs: the reference's ignores it
    t = TF.choose_format(port_csr(a), device="cpu", **{
        k: v for k, v in kw.items() if k != "nrhs"})
    assert type(t).__name__ == type(j).__name__
    np.testing.assert_allclose(TF.to_dense(t), JF.to_dense(j), rtol=0,
                               atol=0)


def test_to_dense_rejects_operators():
    with pytest.raises(TypeError):
        TF.to_dense(np.eye(3))


@pytest.mark.parametrize("fmt", ["ell", "bsr"])
def test_from_numpy_converters(fmt):
    a = jst.laplace3d(4, 3, 3)
    if fmt == "ell":
        j = JF.csr_to_ell(a)
        t = ell_from_numpy(np.asarray(j.cols), np.asarray(j.vals), j.n_rows,
                           j.n_cols, j.nnz, device="cpu")
        n_pad = j.n_rows_pad
    else:
        j = JF.csr_to_bsr(a, 4)
        t = bsr_from_numpy(np.asarray(j.bcols), np.asarray(j.bvals), 4,
                           j.n_rows, j.n_cols, j.nnz, device="cpu")
        n_pad = j.n_brows_pad * 4
    check_applies(j, t, n_pad, 2)


def test_galeri_generators_match():
    for name, p in [("star2d", dict(nx=5, ny=6)),
                    ("bigstar2d", dict(nx=6, ny=5)),
                    ("brick3d", dict(nx=3, ny=4, nz=3)),
                    ("recirc2d", dict(nx=6, ny=5, diff=1e-2)),
                    ("cross2d", dict(nx=4, ny=3, a=4, b=-1, c=-2, d=-0.5,
                                     e=-1.5)),
                    ("laplace3d", dict(nx=3, ny=2, nz=4)),
                    ("uniflow2d", dict(nx=5, ny=4, alpha=0.3)),
                    ("helmholtz2d", dict(nx=5, ny=4, k=3.0)),
                    ("elasticity2d", dict(nx=3, ny=2))]:
        np.testing.assert_array_equal(
            tst.create_matrix(name, p).to_dense(),
            jst.create_matrix(name, p).to_dense(), err_msg=name)
    (ja, jg), (ta, tg) = jst.maxwell2d(4, 3, 2.0), tst.maxwell2d(4, 3, 2.0)
    np.testing.assert_array_equal(ta.to_dense(), ja.to_dense())
    np.testing.assert_array_equal(tg.to_dense(), jg.to_dense())
    with pytest.raises(ValueError, match="unknown Galeri"):
        tst.create_matrix("nope", {})
    # the stencil generators' stored DIA and matrix-free forms
    d = tst.recirc2d(6, 5, diff=1e-2, fmt="dia", device="cpu")
    np.testing.assert_allclose(d.to_dense(),
                               jst.recirc2d(6, 5, diff=1e-2).to_dense(),
                               rtol=1e-14)
    op = tst.brick3d(3, 4, 3, fmt="stencil")
    assert len(op.offsets) == 27
