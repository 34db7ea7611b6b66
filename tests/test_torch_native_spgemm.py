"""The port's native SpGEMM against its numpy path and the JAX package.

``trilinos_tpu_torch/native`` compiles its own copy of the JAX package's
C++ SpGEMM with g++ at first use. Its product must have the numpy path's
structure (rows sorted by column) and values to rounding (1e-14 relative),
and equal the JAX package's ``spgemm`` (which runs the JAX package's own
native helper where it is built). Galerkin-shaped operands: PᵀAP with the
smoothed null-space prolongator of an elasticity level.
"""
import numpy as np
import pytest

from trilinos_tpu.galeri import fem as jfem
from trilinos_tpu.ops import formats as jF
from trilinos_tpu.ops import matrix_ops as jmo
from trilinos_tpu.precond.amg import (
    smooth_prolongator as j_smooth_prolongator,
    tentative_prolongator_nullspace as j_tentative)

from trilinos_tpu_torch import native
from trilinos_tpu_torch.galeri import elasticity3d, rigid_body_modes
from trilinos_tpu_torch.ops import CsrHost, ptap, spgemm, spgemm_numpy
from trilinos_tpu_torch.precond.amg import (smooth_prolongator,
                                            structured_block,
                                            tentative_prolongator_nullspace)
from trilinos_tpu_torch.precond.block_amg import (_gershgorin_dinv_a,
                                                  _structured_node_agg)


def random_pair(rng, m, k, n, density):
    out = []
    for rows, cols in ((m, k), (k, n)):
        nnz = max(int(rows * cols * density), 1)
        out.append((rng.integers(0, rows, nnz), rng.integers(0, cols, nnz),
                    rng.standard_normal(nnz), (rows, cols)))
    return out


def same_structure(c, want, rtol=1e-14):
    assert c.shape == want.shape
    np.testing.assert_array_equal(c.row_ptr, want.row_ptr)
    np.testing.assert_array_equal(c.cols, want.cols)
    scale = np.abs(want.vals).max() if want.nnz else 1.0
    np.testing.assert_allclose(c.vals, want.vals, rtol=0, atol=rtol * scale)


@pytest.mark.parametrize("m,k,n,density", [(40, 30, 50, 0.1),
                                           (200, 80, 120, 0.03),
                                           (7, 5, 3, 0.0)])
def test_native_matches_numpy_and_jax(rng, m, k, n, density):
    (ra, ca, va, sa), (rb, cb, vb, sb) = random_pair(rng, m, k, n, density)
    a, b = CsrHost.from_coo(ra, ca, va, sa), CsrHost.from_coo(rb, cb, vb, sb)
    before = spgemm.native_calls
    c = spgemm(a, b)
    assert spgemm.native_calls == before + 1
    assert c.vals.dtype == np.float64
    same_structure(c, spgemm_numpy(a, b))
    jc = jmo.spgemm(jF.CsrHost.from_coo(ra, ca, va, sa),
                    jF.CsrHost.from_coo(rb, cb, vb, sb))
    same_structure(c, jc)
    np.testing.assert_allclose(c.to_dense(), a.to_dense() @ b.to_dense(),
                               rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="shape mismatch"):
        spgemm(a, a if m != k else b.transpose())


def test_galerkin_product_of_an_elasticity_level():
    dims = (6, 4, 4)
    a = elasticity3d(*dims, e_mod=1.0)
    ns = rigid_body_modes(*dims)
    agg = _structured_node_agg(dims, structured_block(dims))
    p_t, _ = tentative_prolongator_nullspace(agg, 3, ns)
    om = 4.0 / 3.0 / _gershgorin_dinv_a(a)
    p_s = smooth_prolongator(a, p_t, om)
    a_c = ptap(a, p_s)
    assert a_c.shape == (6 * 12, 6 * 12)
    want = p_s.to_dense().T @ a.to_dense() @ p_s.to_dense()
    np.testing.assert_allclose(a_c.to_dense(), want, rtol=0,
                               atol=1e-13 * np.abs(want).max())
    # the numpy path gives the same operator
    same_structure(a_c, spgemm_numpy(spgemm_numpy(p_s.transpose(), a), p_s),
                   rtol=1e-13)
    # and so does the JAX package on its own copies of every host step
    ja = jfem.elasticity3d(*dims, e_mod=1.0)
    jp_t, _ = j_tentative(agg, 3, jfem.rigid_body_modes(*dims))
    jp_s = j_smooth_prolongator(ja, jp_t, 4.0 / 3.0, omega=om)
    same_structure(p_s, jp_s, rtol=0.0)
    same_structure(a_c, jmo.ptap(ja, jp_s), rtol=0.0)


def test_numpy_path_without_a_compiler(monkeypatch, tmp_path):
    """Without g++ the library is unavailable and spgemm takes the numpy
    path, counted apart."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    a = CsrHost.from_coo([0, 1, 1], [1, 0, 1], [2.0, 3.0, 4.0], (2, 2))
    before = (spgemm.native_calls, spgemm.numpy_calls)
    c = spgemm(a, a)
    assert (spgemm.native_calls, spgemm.numpy_calls) == (before[0],
                                                         before[1] + 1)
    np.testing.assert_array_equal(c.to_dense(), a.to_dense() @ a.to_dense())
    assert not list(tmp_path.iterdir())


def test_build_is_keyed_by_source_and_flags(monkeypatch, tmp_path):
    """A fresh build directory gets one library named by the hash of the
    source and flags; other flags name another file."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    path = native.build()
    assert path is not None and path.exists() and path.parent == tmp_path
    assert [p.name for p in tmp_path.iterdir()] == [path.name]
    assert native.build() == path  # built once
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-g",))
    assert native.library_path() != path
