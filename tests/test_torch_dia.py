"""Port parity: stored-DIA storage and SpMV against the JAX package.

Matrices are assembled by both packages' Galeri copies (or handed to both
as the same numpy diagonals) and applied to the same seeded numpy x: the
JAX side through its XLA reference (``dia_spmm``/``dia_spmm_t``) and its
Pallas kernels in interpret mode, the port through its DIA wrapper, which
runs the plain PyTorch version on the CPU. Tolerances are max|Δ| /
max|y|: 1e-13 in f64; 1e-6 where f32 or bf16 data are summed in f32;
1e-5 against the multivector TPU kernels, the tolerance of the JAX
package's own test of them.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trilinos_tpu.galeri import laplace3d as j_laplace3d
from trilinos_tpu.ops import formats as jF
from trilinos_tpu.ops import matvec as jmv
from trilinos_tpu.ops.pallas import dia_spmv as jD
from trilinos_tpu.precond import structured as jS

from trilinos_tpu_torch.convert import dia_from_numpy
from trilinos_tpu_torch.galeri import laplace3d as t_laplace3d
from trilinos_tpu_torch.ops import csr_to_dia, dia_spmm, dia_spmv, spmv
from trilinos_tpu_torch.precond import structured as tS
from torch_threads import one_thread  # noqa: F401  (autouse)


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def rand_x(n_pad, n, dtype, seed):
    x = np.zeros(n_pad, dtype)
    x[:n] = np.random.default_rng(seed).standard_normal(n)
    return x


def same_storage(j, t):
    assert t.offsets == j.offsets
    assert (t.n_rows, t.n_cols, t.nnz, t.n_rows_pad) == (
        j.n_rows, j.n_cols, j.nnz, j.n_rows_pad)
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data_flat))


def test_laplace3d_f64_matches_jax():
    j = j_laplace3d(16, 16, 16, fmt="dia")
    t = t_laplace3d(16, 16, 16, fmt="dia", device="cpu")
    same_storage(j, t)
    x = rand_x(t.n_rows_pad, t.n_rows, np.float64, seed=1)
    y = dia_spmv(t, torch.from_numpy(x)).numpy()
    assert rel(y, jmv.dia_spmm(j, jnp.asarray(x))) <= 1e-13
    # csr_to_dia of the host CSR gives the same storage as direct assembly
    from trilinos_tpu_torch.galeri import stencils as tst

    lap = [((0, 0, 0), 6.0)] + [(o, -1.0) for o in (
        (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1),
        (0, 0, 1))]
    t2 = csr_to_dia(tst.stencil_csr((16, 16, 16), lap), device="cpu")
    assert t2.offsets == t.offsets
    np.testing.assert_array_equal(t2.data.numpy(), t.data.numpy())


def _coarse_level(pkg):
    rep = pkg.ClassifiedStencil.from_constant(
        [(0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0),
         (0, 0, -1), (0, 0, 1)], [6.0] + [-1.0] * 6)
    return pkg.galerkin_classified(rep, (2, 2, 2), 4.0 / 3.0, 0.005)


def test_classified_coarse_level_f64_matches_jax():
    (j_rep, j_om), (t_rep, t_om) = _coarse_level(jS), _coarse_level(tS)
    assert t_om == j_om and t_rep.L == j_rep.L
    assert t_rep.offsets == j_rep.offsets
    for o in j_rep.offsets:
        np.testing.assert_allclose(t_rep.table[o], j_rep.table[o],
                                   rtol=1e-12, atol=1e-14)
    j = j_rep.materialize_dia((8, 8, 8), np.float64, n_rows_pad=1024)
    t = t_rep.materialize_dia((8, 8, 8), np.float64, n_rows_pad=1024,
                              device="cpu")
    assert t.offsets == j.offsets and len(t.offsets) == 33
    np.testing.assert_allclose(t.data.numpy(), np.asarray(j.data_flat),
                               rtol=1e-12, atol=1e-14)
    x = rand_x(1024, 512, np.float64, seed=2)
    y = spmv(t, torch.from_numpy(x)).numpy()
    assert rel(y, jmv.dia_spmm(j, jnp.asarray(x))) <= 1e-13


def test_f32_matches_jax_kernels():
    """Both TPU kernels the port's DIA kernel replaces, in interpret mode:
    the ring kernel (k = 1) and the window kernel."""
    j = j_laplace3d(16, 16, 16, dtype=np.float32, fmt="dia")
    t = dia_from_numpy(np.asarray(j.data), j.offsets, j.n_rows, j.n_cols,
                       j.nnz, device="cpu")
    assert t.data.shape == (7, 4096) and t.dtype == torch.float32
    x = rand_x(t.n_rows_pad, t.n_rows, np.float32, seed=3)
    y = dia_spmv(t, torch.from_numpy(x)).numpy()
    ring = jD.dia_spmm_ring(j, jnp.asarray(x).reshape(1, -1, 128),
                            interpret=True)
    assert rel(y, np.asarray(ring).reshape(-1)) <= 1e-6
    assert rel(y, jD.dia_spmv_pallas(j, jnp.asarray(x),
                                     interpret=True)) <= 1e-6


def test_bf16_data_f32_x_matches_jax():
    j32 = j_laplace3d(16, 16, 16, dtype=np.float32, fmt="dia")
    # non-trivial bf16 values: scale the diagonals by random factors
    scale = np.random.default_rng(4).uniform(0.5, 2.0, (7, 1, 1))
    data32 = (np.asarray(j32.data) * scale).astype(np.float32)
    j = jF.DiaMatrix(data=jnp.asarray(data32).astype(jnp.bfloat16),
                     offsets=j32.offsets, n_rows=j32.n_rows,
                     n_cols=j32.n_cols, nnz=j32.nnz)
    t = dia_from_numpy(np.asarray(j.data), j.offsets, j.n_rows, j.n_cols,
                       j.nnz, device="cpu")
    assert t.dtype == torch.bfloat16
    x = rand_x(t.n_rows_pad, t.n_rows, np.float32, seed=5)
    y = dia_spmv(t, torch.from_numpy(x))
    assert y.dtype == torch.float32
    assert rel(y.numpy(), jmv.dia_spmm(j, jnp.asarray(x))) <= 1e-6
    ring = jD.dia_spmm_ring(j, jnp.asarray(x).reshape(1, -1, 128),
                            interpret=True)
    assert rel(y.numpy(), np.asarray(ring).reshape(-1)) <= 1e-6


def _jax_packed_kernels(j, x, k):
    """Every TPU multivector DIA kernel whose plan takes (j, k), in
    interpret mode, on the packed (k, R, 128) layout; results unpacked to
    (n_pad, k)."""
    n = j.n_rows_pad
    xk = jnp.asarray(x).T.reshape(k, n // 128, 128)
    out = {}
    if jD._plan_ring(j.offsets, n, j.data.shape[0], k) is not None:
        out["ring"] = jD.dia_spmm_ring(j, xk, interpret=True)
    if jD._plan_mv(j.offsets, n, j.data.shape[0], k) is not None:
        out["window"] = jD.dia_spmm_packed(j, xk, interpret=True)
    return {name: np.asarray(y).reshape(k, n).T for name, y in out.items()}


@pytest.mark.parametrize("k", [2, 4, 8, 16])
@pytest.mark.parametrize("data_dtype", ["float32", "bfloat16"])
def test_multivector_matches_jax_kernels(k, data_dtype):
    """The TPU kernels the port's multivector DIA kernel replaces
    (``dia_spmm_ring`` at k > 1 and ``dia_spmm_packed``), in interpret
    mode, on the JAX package's own test geometry; f32 or bf16 data, f32 x
    and sums."""
    j32 = j_laplace3d(32, 16, 16, dtype=np.float32, fmt="dia")
    data = np.asarray(j32.data)
    if data_dtype == "bfloat16":
        scale = np.random.default_rng(10).uniform(0.5, 2.0, (7, 1, 1))
        data = (data * scale).astype(np.float32)
    j = jF.DiaMatrix(data=jnp.asarray(data).astype(data_dtype),
                     offsets=j32.offsets, n_rows=j32.n_rows,
                     n_cols=j32.n_cols, nnz=j32.nnz)
    t = dia_from_numpy(np.asarray(j.data), j.offsets, j.n_rows, j.n_cols,
                       j.nnz, device="cpu")
    x = np.zeros((t.n_rows_pad, k), np.float32)
    x[:t.n_rows] = np.random.default_rng(11).standard_normal((t.n_rows, k))
    y = dia_spmv(t, torch.from_numpy(x))
    assert y.dtype == torch.float32 and y.shape == (t.n_rows_pad, k)
    np.testing.assert_array_equal(
        dia_spmm(t, torch.from_numpy(x)).numpy(), y.numpy())
    kernels = _jax_packed_kernels(j, x, k)
    assert kernels, "no TPU kernel plans this case"
    for name, want in kernels.items():
        assert rel(y.numpy(), want) <= 1e-5, name
    assert rel(y.numpy(), jmv.dia_spmm(j, jnp.asarray(x))) <= 1e-6


def _random_dia(seed):
    """Random nonsymmetric diagonals with zeros where the column falls
    outside the matrix (the DIA storage invariant)."""
    n, n_pad, offsets = 1000, 1024, (-37, -5, -1, 0, 2, 7, 64)
    rng = np.random.default_rng(seed)
    data = np.zeros((len(offsets), n_pad))
    rows = np.arange(n)
    for d, o in enumerate(offsets):
        ok = (rows + o >= 0) & (rows + o < n)
        data[d, rows[ok]] = rng.standard_normal(int(ok.sum()))
    return data, offsets, n, n_pad


def test_transpose_matches_jax():
    data, offsets, n, n_pad = _random_dia(6)
    nnz = int(np.count_nonzero(data))
    j = jF.DiaMatrix(data=jnp.asarray(data), offsets=offsets, n_rows=n,
                     n_cols=n, nnz=nnz)
    t = dia_from_numpy(data, offsets, n, n, nnz, device="cpu")
    x = rand_x(n_pad, n, np.float64, seed=7)
    xt = torch.from_numpy(x)
    yt = spmv(t, xt, transpose=True).numpy()
    assert rel(yt, jmv.dia_spmm_t(j, jnp.asarray(x))) <= 1e-13
    dense = t.to_dense()
    assert rel(yt[:n], dense.T @ x[:n]) <= 1e-13
    assert rel(spmv(t, xt).numpy()[:n], dense @ x[:n]) <= 1e-13


def test_multivector_and_shape_checks():
    data, offsets, n, n_pad = _random_dia(8)
    t = dia_from_numpy(data, offsets, n, n, 0, device="cpu")
    xk = np.zeros((n_pad, 2))
    xk[:n] = np.random.default_rng(9).standard_normal((n, 2))
    yk = spmv(t, torch.from_numpy(xk)).numpy()
    for c in range(2):
        np.testing.assert_array_equal(
            yk[:, c], spmv(t, torch.from_numpy(xk[:, c].copy())).numpy())
    with pytest.raises(ValueError, match="x length"):
        dia_spmv(t, torch.zeros(n_pad + 8, dtype=torch.float64))
    with pytest.raises(ValueError, match="x length"):
        dia_spmm(t, torch.zeros((n_pad + 8, 2), dtype=torch.float64))
    with pytest.raises(ValueError, match="not supported"):
        dia_spmm(t, torch.zeros((n_pad, 2), device="meta"))
    with pytest.raises(ValueError, match="does not match"):
        dia_from_numpy(data[:3], offsets, n, n, 0, device="cpu")
