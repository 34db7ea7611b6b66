"""Port parity: the FE Galeri problems and FE assembly against the JAX
package.

``galeri/fem.py`` and ``ops.fe.fe_assemble`` are host numpy copies, so the
port's CSR (row_ptr, cols, vals) must equal the JAX package's exactly,
in f64 and f32, and the rigid-body modes too.
"""
import numpy as np
import pytest

from trilinos_tpu.galeri import fem as jfem
from trilinos_tpu.ops.fe import fe_assemble as j_fe_assemble

from trilinos_tpu_torch.galeri import (elasticity2d, elasticity3d,
                                       helmholtz2d, rigid_body_modes,
                                       uniflow2d)
from trilinos_tpu_torch.ops.fe import fe_assemble


def same_csr(t, j):
    assert t.shape == j.shape
    np.testing.assert_array_equal(t.row_ptr, j.row_ptr)
    np.testing.assert_array_equal(t.cols, j.cols)
    assert t.vals.dtype == j.vals.dtype
    np.testing.assert_array_equal(t.vals, j.vals)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_elasticity_matches_jax(dtype):
    same_csr(elasticity2d(7, 5, dtype=dtype), jfem.elasticity2d(7, 5,
                                                                 dtype=dtype))
    same_csr(elasticity2d(6, 4, e_mod=1.0, nu=0.3, dtype=dtype),
             jfem.elasticity2d(6, 4, e_mod=1.0, nu=0.3, dtype=dtype))
    a = elasticity3d(5, 4, 3, e_mod=1.0, dtype=dtype)
    same_csr(a, jfem.elasticity3d(5, 4, 3, e_mod=1.0, dtype=dtype))
    # Q1 hexahedra: an interior node couples to its 27 neighbours
    assert a.shape == (180, 180) and a.row_lengths().max() == 81
    np.testing.assert_allclose(a.to_dense(), a.to_dense().T, rtol=0,
                               atol=1e-6 if dtype == np.float32 else 1e-15)


def test_rigid_body_modes_match_jax():
    np.testing.assert_array_equal(rigid_body_modes(6, 5),
                                  jfem.rigid_body_modes(6, 5))
    ns = rigid_body_modes(5, 4, 3)
    np.testing.assert_array_equal(ns, jfem.rigid_body_modes(5, 4, 3))
    assert ns.shape == (180, 6)
    # the modes lie in the null space of the unshifted interior rows
    a = elasticity3d(5, 4, 3, e_mod=1.0).to_dense()
    interior = 3 * (1 + 5 * (1 + 4 * 1)) + np.arange(3)
    np.testing.assert_allclose(a[interior] @ ns, 0.0, atol=1e-12)


def test_stencil_problems_match_jax():
    same_csr(helmholtz2d(6, 5, k=3.0), jfem.helmholtz2d(6, 5, k=3.0))
    same_csr(uniflow2d(6, 5, alpha=0.7), jfem.uniflow2d(6, 5, alpha=0.7))
    same_csr(uniflow2d(5, 4, alpha=2.5, conv=2.0),
             jfem.uniflow2d(5, 4, alpha=2.5, conv=2.0))


def test_fe_assemble_matches_jax(rng):
    n_dofs, ne, k = 15, 9, 4
    connect = np.stack([rng.choice(n_dofs, k, replace=False)
                        for _ in range(ne)])
    mats = rng.standard_normal((ne, k, k))
    t = fe_assemble(connect, mats, n_dofs)
    same_csr(t, j_fe_assemble(connect, mats, n_dofs))
    want = np.zeros((n_dofs, n_dofs))
    for c, m in zip(connect, mats):
        want[np.ix_(c, c)] += m
    np.testing.assert_allclose(t.to_dense(), want, rtol=1e-14, atol=1e-14)
