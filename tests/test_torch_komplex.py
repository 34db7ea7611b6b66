"""The port's Komplex (complex systems through the equivalent real form)
against the JAX package's.

The real form of a complex ``CsrHost`` (as the Matrix Market reader gives
a complex file), of an ``(ar, ai)`` pair and of a dense complex array
equals the reference's bit for bit; vectors round-trip with and without
padding. ``solve_complex`` through ``build`` (unpreconditioned GMRES(30), or
GMRES(30) with RILUK) takes the reference's iteration count on the same
inputs, f64, with the complex solution to 1e-8 of the reference's and the
complex true residual at the tolerance. ``komplex_entry`` at 16² reads its
complex file through the Python parser (the native reader declines
complex files), stores the real form as DIA (offsets ±n hold the shift)
and matches the JAX package's solve of the same matrix.
"""
import numpy as np
import pytest
import torch

from trilinos_tpu.io import read_sparse as j_read_sparse
from trilinos_tpu.ops import formats as JF
from trilinos_tpu.ops import komplex as jk

from trilinos_tpu_torch.entry import KOMPLEX_PARAMS, komplex_entry
from trilinos_tpu_torch.io import matrix_market as tmm
from trilinos_tpu_torch.ops import DiaMatrix, choose_format, dia_spmv
from trilinos_tpu_torch.ops import formats as TF
from trilinos_tpu_torch.ops import komplex as tk
from torch_threads import one_thread  # noqa: F401  (autouse)


def port_csr(a):
    return TF.CsrHost(a.row_ptr, a.cols, a.vals, a.shape)


def same_csr(got, want):
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(got.row_ptr, want.row_ptr)
    np.testing.assert_array_equal(got.cols, want.cols)
    np.testing.assert_array_equal(got.vals, want.vals)


def dense_system(n, diag, seed):
    rng = np.random.default_rng(seed)
    az = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
          + diag * np.eye(n))
    return az, rng.standard_normal(n) + 1j * rng.standard_normal(n)


def test_real_form_matches_jax():
    az, _ = dense_system(12, 6, 0)
    az[np.abs(az) < 0.5] = 0
    same_csr(tk.complex_matrix_to_real(az), jk.complex_matrix_to_real(az))
    csr = JF.CsrHost.from_dense(az)
    same_csr(tk.complex_matrix_to_real(port_csr(csr)),
             jk.complex_matrix_to_real(csr))
    ar, ai = JF.CsrHost.from_dense(az.real), JF.CsrHost.from_dense(az.imag)
    got = tk.complex_to_real_csr(port_csr(ar), port_csr(ai))
    same_csr(got, jk.complex_to_real_csr(ar, ai))
    np.testing.assert_array_equal(
        got.to_dense(), np.block([[az.real, -az.imag], [az.imag, az.real]]))
    with pytest.raises(ValueError, match="shape"):
        tk.complex_to_real_csr(port_csr(ar), port_csr(
            JF.CsrHost.from_dense(np.eye(3))))


@pytest.mark.parametrize("n_pad", [None, 16])
def test_vector_round_trip(n_pad):
    _, z = dense_system(12, 0, 1)
    got = tk.complex_vec_to_real(z, n_pad)
    np.testing.assert_array_equal(got, np.asarray(jk.complex_vec_to_real(
        z, n_pad)))
    np.testing.assert_array_equal(
        tk.real_vec_to_complex(torch.from_numpy(got), 12, n_pad), z)
    np.testing.assert_array_equal(tk.real_vec_to_complex(got, 12, n_pad), z)


def test_solve_complex_matches_jax():
    az, bz = dense_system(24, 10, 3)
    params = {"Linear Solver Type": "GMRES",
              "Solver Types": {"GMRES": {"Convergence Tolerance": 1e-10,
                                         "Num Blocks": 30}},
              "Preconditioner Type": "None"}
    z, res = tk.solve_complex(az, bz, params, device="cpu")
    jz, jres = jk.solve_complex(az, bz, params)
    assert bool(res.converged) and res.iters == int(jres.iters)
    assert np.abs(z - jz).max() <= 1e-8 * np.abs(jz).max()
    assert np.linalg.norm(bz - az @ z) <= 1e-9 * np.linalg.norm(bz)
    ar = port_csr(JF.CsrHost.from_dense(az.real))
    ai = port_csr(JF.CsrHost.from_dense(az.imag))
    zp, _ = tk.solve_complex((ar, ai), bz, params, device="cpu")
    assert np.abs(zp - z).max() <= 1e-12 * np.abs(z).max()
    with pytest.raises(ValueError, match="rhs length"):
        tk.solve_complex((ar, ai), bz[:-1], device="cpu")


def test_komplex_entry_matches_jax(tmp_path):
    path = tmp_path / "shifted.mtx"
    before = (tmm.read_sparse.native_calls, tmm.read_sparse.python_calls)
    step, (bz,) = komplex_entry(16, device="cpu", path=path)
    assert (tmm.read_sparse.native_calls, tmm.read_sparse.python_calls) == (
        before[0], before[1] + 1)
    a = j_read_sparse(str(path))
    same_csr(step.matrix, a)
    assert np.iscomplexobj(a.vals) and a.shape == (256, 256)
    erf = tk.complex_matrix_to_real(step.matrix)
    op = choose_format(erf, device="cpu")
    assert isinstance(op, DiaMatrix) and {256, -256} <= set(op.offsets)
    dia_spmv.launches = 0
    z, res = step(bz)
    assert dia_spmv.launches == 0
    jz, jres = jk.solve_complex(a, bz, KOMPLEX_PARAMS)
    assert bool(res.converged) and res.iters == int(jres.iters)
    assert np.abs(z - jz).max() <= 1e-8 * np.abs(jz).max()
    true = np.linalg.norm(bz - a.to_dense() @ z) / np.linalg.norm(bz)
    assert true <= 1e-7
