"""The port's FE discretisation layer (``trilinos_tpu_torch/fem``, the
element apply and vector assembly of ``ops/fe.py``, ``io/vtk.py``) and
``fem_poisson_entry``, against the JAX package on the CPU.

The ``fem`` modules are host numpy copies, so bases, cubature rules,
Jacobians, meshes, dof numberings, the stiffness, mass and load CSRs,
``poisson_dirichlet``, ``refine_uniform`` and the mortar projection are
held to the JAX package's bit for bit, on the topologies and degrees of
``tests/test_fem.py``, ``tests/test_refine.py`` and ``tests/test_mortar.py``
(the port numbers dofs by one ``np.lexsort`` where the JAX package calls
``np.unique(axis=0)``: the same numbering). The mortar glue's K_red comes
from the port's native SpGEMM, which sums a row's products in another
order than the JAX package's, so it is held to 1e-14 relative.
``fe_apply_local`` (torch) and ``fe_assemble_vector`` are held to the JAX
functions in float64 to 1e-13. Both packages' VTK files for the same mesh
and fields are byte-equal. ``fem_poisson_entry`` at 8³ elements in
float64 matches the JAX pipeline (``poisson_dirichlet`` → uncoupled
``SaAmg`` → ``cg``): the assembled form the iteration count, the
matrix-free form within one, both x to 1e-10.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_threads import one_thread  # noqa: F401  (autouse)
from trilinos_tpu import fem as jfem
from trilinos_tpu.fem import mortar as jmortar
from trilinos_tpu.fem import refine as jrefine
from trilinos_tpu.io import vtk as jvtk
from trilinos_tpu.ops import fe as jfe
from trilinos_tpu.ops import spmv as j_spmv
from trilinos_tpu.precond import SaAmg as JSaAmg
from trilinos_tpu.solvers import cg as j_cg
from trilinos_tpu_torch import fem
from trilinos_tpu_torch.entry import (FEM_MAXITER, FEM_RTOL,
                                      fem_poisson_entry, fem_poisson_problem,
                                      fem_source)
from trilinos_tpu_torch.fem import mortar, refine
from trilinos_tpu_torch.fem.basis import hgrad_basis
from trilinos_tpu_torch.fem.cubature import cubature
from trilinos_tpu_torch.fem.mesh import fe_space
from trilinos_tpu_torch.io import read_vtk, vtk, write_vtk, write_vtk_series
from trilinos_tpu_torch.ops import fe

TOPOS = ["LINE2", "TRI3", "QUAD4", "TET4", "HEX8"]
BASES = [("LINE2", 1), ("LINE2", 3), ("TRI3", 1), ("TRI3", 2),
         ("QUAD4", 1), ("QUAD4", 2), ("TET4", 1), ("HEX8", 1), ("HEX8", 2)]
CUBATURES = [("TRI3", 1), ("TRI3", 2), ("TRI3", 3), ("TRI3", 5),
             ("TET4", 1), ("TET4", 2), ("TET4", 3), ("QUAD4", 4),
             ("HEX8", 3), ("LINE2", 5)]
# mesher name, arguments, basis degree
MESHES = [("structured_quad_mesh", (3, 3), 1),
          ("structured_quad_mesh", (4, 3), 2),
          ("structured_tri_mesh", (4, 4), 1),
          ("structured_tri_mesh", (3, 5), 2),
          ("structured_hex_mesh", (2, 2, 2), 1),
          ("structured_hex_mesh", (2, 1, 2), 2),
          ("structured_tet_mesh", (2, 2, 2), 1)]
REFINE = [("structured_tri_mesh", (2, 3)), ("structured_quad_mesh", (3, 2)),
          ("structured_hex_mesh", (2, 2, 2)),
          ("structured_tet_mesh", (2, 2, 2))]
APPLY_TOL = 1e-13
GLUE_TOL = 1e-14
ENTRY_DIMS = (8, 8, 8)
ENTRY_X_TOL = 1e-10


def same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def same_csr(got, want):
    assert tuple(got.shape) == tuple(want.shape)
    same(got.row_ptr, want.row_ptr)
    same(got.cols, want.cols)
    same(got.vals, want.vals)


def meshes(name, args):
    return getattr(fem, name)(*args), getattr(jfem, name)(*args)


def source(x):
    return 2 * np.pi ** 2 * np.sin(np.pi * x[..., 0]) * np.sin(
        np.pi * x[..., 1])


# -- cells, bases, cubature, cell tools --------------------------------------

@pytest.mark.parametrize("topo", TOPOS)
def test_cells_match(topo):
    got, want = getattr(fem, topo), getattr(jfem, topo)
    assert (got.name, got.dim, got.family) == (want.name, want.dim,
                                                want.family)
    same(got.vertices, want.vertices)


@pytest.mark.parametrize("topo,deg", BASES)
def test_basis_tables_match(topo, deg):
    b = hgrad_basis(getattr(fem, topo), deg)
    jb = jfem.hgrad_basis(getattr(jfem, topo), deg)
    assert b.n_dofs == jb.n_dofs
    same(b.dof_coords, jb.dof_coords)
    qp, _ = cubature(getattr(fem, topo), 3)
    same(b.values(qp), jb.values(qp))
    same(b.grads(qp), jb.grads(qp))
    same(fem.lagrange_nodes_1d(deg), jfem.lagrange_nodes_1d(deg))


@pytest.mark.parametrize("topo,deg", CUBATURES)
def test_cubature_matches(topo, deg):
    qp, qw = cubature(getattr(fem, topo), deg)
    jqp, jqw = jfem.cubature(getattr(jfem, topo), deg)
    same(qp, jqp)
    same(qw, jqw)


@pytest.mark.parametrize("name,args,deg", MESHES)
def test_cell_tools_match(name, args, deg):
    m, jm = meshes(name, args)
    qp, _ = cubature(m.topo, 2)
    geom, jgeom = hgrad_basis(m.topo, 1), jfem.hgrad_basis(jm.topo, 1)
    j = fem.jacobian(m.cell_coords, qp, geom)
    jj = jfem.jacobian(jm.cell_coords, qp, jgeom)
    same(j, jj)
    same(fem.jacobian_det(j), jfem.jacobian_det(jj))
    same(fem.jacobian_inv(j), jfem.jacobian_inv(jj))
    same(fem.map_to_physical(m.cell_coords, qp, geom),
         jfem.map_to_physical(jm.cell_coords, qp, jgeom))
    b = hgrad_basis(m.topo, deg)
    same(fem.hgrad_transform_grad(fem.jacobian_inv(j), b.grads(qp)),
         jfem.hgrad_transform_grad(jfem.jacobian_inv(jj),
                                   jfem.hgrad_basis(jm.topo, deg).grads(qp)))


# -- meshes, dof numbering, assembly -----------------------------------------

@pytest.mark.parametrize("name,args,deg", MESHES)
def test_mesh_and_fe_space_match(name, args, deg):
    m, jm = meshes(name, args)
    assert m.topo.name == jm.topo.name
    same(m.coords, jm.coords)
    same(m.connect, jm.connect)
    conn, xy = fe_space(m, hgrad_basis(m.topo, deg))
    jconn, jxy = jfem.mesh.fe_space(jm, jfem.hgrad_basis(jm.topo, deg))
    same(conn, jconn)
    same(xy, jxy)


@pytest.mark.parametrize("name,args,deg", MESHES)
def test_stiffness_mass_load_match(name, args, deg):
    m, jm = meshes(name, args)
    b, jb = hgrad_basis(m.topo, deg), jfem.hgrad_basis(jm.topo, deg)
    for port, ref in (
            (fem.stiffness_matrix(m, b), jfem.stiffness_matrix(jm, jb)),
            (fem.mass_matrix(m, b), jfem.mass_matrix(jm, jb))):
        same_csr(port[0], ref[0])
        same(port[1], ref[1])
        same(port[2], ref[2])

    def f(x):
        return 1.0 + x[..., 0] * x[..., -1]
    load, conn, xy = fem.load_vector(m, f, b)
    jload, jconn, jxy = jfem.load_vector(jm, f, jb)
    same(load, jload)
    same(conn, jconn)


def test_variable_coefficient_stiffness_matches():
    m, jm = meshes("structured_quad_mesh", (5, 5))

    def coeff(x):
        return 1.0 + x[..., 0] + 2 * x[..., 1]
    same_csr(fem.stiffness_matrix(m, coeff=coeff)[0],
             jfem.stiffness_matrix(jm, coeff=coeff)[0])


@pytest.mark.parametrize("name,args,deg", MESHES[:4])
def test_poisson_dirichlet_matches(name, args, deg):
    m, jm = meshes(name, args)
    b, jb = hgrad_basis(m.topo, deg), jfem.hgrad_basis(jm.topo, deg)
    for g in (None, lambda x: x[:, 0] + 2.0 * x[:, 1]):
        got = fem.poisson_dirichlet(m, source, b, g=g)
        want = jfem.poisson_dirichlet(jm, source, jb, g=g)
        same_csr(got[0], want[0])
        for a, w in zip(got[1:], want[1:]):
            same(a, w)


def test_poisson_elements_assemble_to_k():
    """``elements=True``: the element matrices and connectivity that K was
    assembled from."""
    m = fem.structured_hex_mesh(3, 2, 2)
    kii, load, interior, xy, ke, conn = fem.poisson_dirichlet(
        m, fem_source, elements=True)
    same_csr(kii, fem.poisson_dirichlet(m, fem_source)[0])
    k, kconn, _ = fem.stiffness_matrix(m)
    assert ke.shape == (len(m.connect), 8, 8)
    same(conn, kconn)
    same_csr(fe.fe_assemble(conn, ke, len(xy)), k)


# -- refinement and mortar ----------------------------------------------------

@pytest.mark.parametrize("name,args", REFINE)
@pytest.mark.parametrize("times", [1, 2])
def test_refine_uniform_matches(name, args, times):
    m, jm = meshes(name, args)
    got = refine.refine_uniform(m, times=times)
    want = jrefine.refine_uniform(jm, times=times)
    assert got.topo.name == want.topo.name
    same(got.coords, want.coords)
    same(got.connect, want.connect)


def test_refine_unsupported_topology_raises():
    bad = fem.Mesh(fem.LINE2, np.zeros((2, 1)), np.array([[0, 1]]))
    with pytest.raises(ValueError, match="unsupported"):
        refine.refine_uniform(bad)


@pytest.mark.parametrize("kind", ["dual", "standard"])
@pytest.mark.parametrize("end_mod", [True, False])
@pytest.mark.parametrize("grids", [(5, 7), (9, 4), (6, 6)])
def test_mortar_projection_matches(kind, end_mod, grids):
    xs = np.linspace(0.0, 1.0, grids[0]) ** 1.3
    xm = np.linspace(0.0, 1.0, grids[1])
    got = mortar.mortar_projection_1d(xs, xm, kind=kind,
                                      end_modification=end_mod)
    want = jmortar.mortar_projection_1d(xs, xm, kind=kind,
                                        end_modification=end_mod)
    for a, w in zip(got, want):
        same(a, w)


def test_mortar_projection_validation_matches():
    for xs, xm in ((np.linspace(0, 1, 4), np.linspace(0, 0.9, 5)),
                   (np.array([0.0, 0.5, 0.4, 1.0]), np.linspace(0, 1, 3)),
                   (np.array([0.0]), np.linspace(0, 1, 3))):
        with pytest.raises(ValueError) as got:
            mortar.mortar_projection_1d(xs, xm)
        with pytest.raises(ValueError) as want:
            jmortar.mortar_projection_1d(xs, xm)
        assert str(got.value) == str(want.value)


def _glued(pkg, mort, kind):
    """The mortar twin's two unit squares' halves, glued at y = 0.5 on
    nonmatching grids (8x4 below, 5x4 above)."""
    def half(nx, ny, y0):
        m = pkg.structured_quad_mesh(nx, ny)
        coords = m.coords.copy()
        coords[:, 1] = y0 + 0.5 * coords[:, 1]
        return pkg.Mesh(m.topo, coords, m.connect)

    ma, mb = half(8, 4, 0.0), half(5, 4, 0.5)
    k_a, _, xy_a = pkg.stiffness_matrix(ma)
    k_b, _, xy_b = pkg.stiffness_matrix(mb)
    f_a = pkg.load_vector(ma, source)[0]
    f_b = pkg.load_vector(mb, source)[0]
    master, xm = mort.interface_dofs(xy_a, axis=1, value=0.5)
    slave, xs = mort.interface_dofs(xy_b, axis=1, value=0.5)
    d, m, p = mort.mortar_projection_1d(xs, xm, kind=kind)
    glue = mort.mortar_glue(k_a, k_b, f_a, f_b, slave, master, p)
    saddle = mort.mortar_saddle(k_a, k_b, slave, master, d, m)
    return (master, xm, slave, xs), glue, saddle, mort.block_diag(k_a, k_b)


@pytest.mark.parametrize("kind", ["dual", "standard"])
def test_mortar_glue_and_saddle_match(kind):
    got_if, (k_red, f_red, c, red), (k_full, bmat), bd = _glued(fem, mortar,
                                                                kind)
    want_if, (jk_red, jf_red, jc, jred), (jk_full, jbmat), jbd = _glued(
        jfem, jmortar, kind)
    for a, w in zip(got_if, want_if):
        same(a, w)
    same_csr(c, jc)
    same(red, jred)
    same_csr(k_full, jk_full)
    same_csr(bmat, jbmat)
    same_csr(bd, jbd)
    same(f_red, jf_red)
    # the native SpGEMM's summation order
    same(k_red.row_ptr, jk_red.row_ptr)
    same(k_red.cols, jk_red.cols)
    np.testing.assert_allclose(k_red.vals, jk_red.vals, rtol=0,
                               atol=GLUE_TOL * np.abs(jk_red.vals).max())


# -- ops/fe.py: the element apply and vector assembly -------------------------

@functools.lru_cache(maxsize=None)
def apply_case():
    rng = np.random.default_rng(42)
    ne, k, n = 30, 4, 25
    return (rng.integers(0, n, (ne, k)), rng.standard_normal((ne, k, k)),
            rng.standard_normal(n), rng.standard_normal((n, 3)))


@pytest.mark.parametrize("cols", [None, 3])
def test_fe_apply_local_matches_jax(cols):
    connect, mats, x1, x3 = apply_case()
    x = x1 if cols is None else x3
    y = fe.fe_apply_local(torch.from_numpy(connect), torch.from_numpy(mats),
                          torch.from_numpy(x))
    jy = np.asarray(jfe.fe_apply_local(jnp.asarray(connect),
                                       jnp.asarray(mats), jnp.asarray(x)))
    assert tuple(y.shape) == x.shape and y.dtype == torch.float64
    np.testing.assert_allclose(y.numpy(), jy, rtol=APPLY_TOL,
                               atol=APPLY_TOL * np.abs(jy).max())
    a = fe.fe_assemble(connect, mats, x.shape[0])
    np.testing.assert_allclose(y.numpy(), a.to_dense() @ x, rtol=APPLY_TOL,
                               atol=APPLY_TOL * np.abs(jy).max())


def test_fe_apply_local_in_the_element_dtype():
    """float32 element matrices on a float64 x: the product in float32,
    the sum back in float64, as the JAX function."""
    connect, mats, x, _ = apply_case()
    y = fe.fe_apply_local(torch.from_numpy(connect),
                          torch.from_numpy(mats.astype(np.float32)),
                          torch.from_numpy(x))
    jy = np.asarray(jfe.fe_apply_local(
        jnp.asarray(connect), jnp.asarray(mats.astype(np.float32)),
        jnp.asarray(x)))
    assert y.dtype == torch.float64
    np.testing.assert_allclose(y.numpy(), jy, rtol=1e-5, atol=1e-5)


def test_fe_assemble_vector_matches_jax():
    connect, mats, _, _ = apply_case()
    vecs = mats[:, 0, :]
    same(fe.fe_assemble_vector(connect, vecs, 25),
         jfe.fe_assemble_vector(connect, vecs, 25))
    np.testing.assert_allclose(
        fe.fe_assemble_vector(np.array([[0, 1], [1, 2]]),
                              np.array([[1.0, 2.0], [3.0, 4.0]]), 3),
        [1.0, 5.0, 4.0])


# -- io/vtk.py ---------------------------------------------------------------

def vtk_cases():
    rng = np.random.default_rng(3)
    out = []
    for name, args in (("structured_hex_mesh", (2, 3, 2)),
                       ("structured_quad_mesh", (3, 2)),
                       ("structured_tri_mesh", (2, 2)),
                       ("structured_tet_mesh", (1, 2, 1))):
        m, jm = meshes(name, args)
        pd = {"u": rng.standard_normal(len(m.coords)),
              "v": rng.standard_normal((len(m.coords), m.topo.dim))}
        cd = {"c": rng.standard_normal(len(m.connect))}
        out.append((name, m, jm, pd, cd))
    return out


@pytest.mark.parametrize("case", range(4))
def test_vtk_files_byte_equal_and_round_trip(tmp_path, case):
    name, m, jm, pd, cd = vtk_cases()[case]
    write_vtk(tmp_path / "port.vtk", m, point_data=pd, cell_data=cd)
    jvtk.write_vtk(tmp_path / "jax.vtk", jm, point_data=pd, cell_data=cd)
    assert (tmp_path / "port.vtk").read_bytes() == (
        tmp_path / "jax.vtk").read_bytes()
    topo, coords, connect, rpd, rcd = read_vtk(tmp_path / "port.vtk")
    assert topo == m.topo.name
    same(connect, m.connect)  # back in fem (lexicographic) order
    np.testing.assert_array_equal(coords[:, :m.coords.shape[1]], m.coords)
    same(rpd["u"], pd["u"])
    same(rpd["v"][:, :m.topo.dim], pd["v"])
    same(rcd["c"], cd["c"])
    want = jvtk.read_vtk(tmp_path / "jax.vtk")
    for a, w in zip((coords, connect), want[1:3]):
        same(a, w)


def test_vtk_tuple_mesh_and_series_byte_equal(tmp_path):
    m = fem.structured_quad_mesh(2, 2)
    triple = ("quad4", m.coords, m.connect)
    steps = [({"u": np.full(len(m.coords), t)}, None) for t in (0.0, 1.5)]
    paths = write_vtk_series(str(tmp_path / "p"), triple, steps,
                             times=[0.0, 0.25])
    jpaths = jvtk.write_vtk_series(str(tmp_path / "j"), triple, steps,
                                   times=[0.0, 0.25])
    assert len(paths) == len(jpaths) == 2
    for a, b in zip(paths, jpaths):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    series = (tmp_path / "p.vtk.series").read_text()
    assert series == (tmp_path / "j.vtk.series").read_text().replace(
        "j_00", "p_00")
    with pytest.raises(ValueError) as got:
        vtk.write_vtk(str(tmp_path / "bad.vtk"), m,
                      point_data={"u": np.zeros(3)})
    with pytest.raises(ValueError) as want:
        jvtk.write_vtk(str(tmp_path / "bad.vtk"), m,
                       point_data={"u": np.zeros(3)})
    assert str(got.value) == str(want.value)


# -- fem_poisson_entry against the JAX pipeline -------------------------------

@functools.lru_cache(maxsize=None)
def jax_poisson(b_key):
    """poisson_dirichlet → uncoupled SaAmg → cg in the JAX package, f64,
    from the port's right-hand side (seed-0 normals, zero pad rows) and
    on its manufactured load."""
    jm = jfem.structured_hex_mesh(*ENTRY_DIMS)
    kii, load, interior, xy = jfem.poisson_dirichlet(jm, fem_source)
    amg = JSaAmg(kii, {"dtype": np.float64,
                       "aggregation: type": "uncoupled"}).compute()
    st = amg.state()
    fine = st["levels"][0]["a"]
    out = {}
    for label, b in b_key:
        res = j_cg(lambda v: j_spmv(fine, v), jnp.asarray(np.array(b)),
                   prec=lambda v: amg.apply_state(st, v), rtol=FEM_RTOL,
                   maxiter=FEM_MAXITER)
        out[label] = (int(res.iters), np.asarray(res.x), bool(res.converged))
    return out, kii, load


@functools.lru_cache(maxsize=None)
def port_poisson():
    prob = fem_poisson_problem(ENTRY_DIMS)
    step, (b, st) = fem_poisson_entry(ENTRY_DIMS, device="cpu",
                                      problem=prob)
    mf, _ = fem_poisson_entry(ENTRY_DIMS, amg=step.preconditioner,
                              matrix_free=True, problem=prob)
    return prob, step, mf, b, st


def test_fem_poisson_problem_matches_jax():
    prob, step, _, b, _ = port_poisson()
    _, kii, load = jax_poisson((("rhs", tuple(b.numpy())),))
    assert prob.kii.shape == (7 ** 3, 7 ** 3)
    same_csr(prob.kii, kii)
    same(prob.load, load)
    assert type(step.operator).__name__ == "DiaMatrix"
    assert len(step.operator.offsets) == 27
    assert set(step.setup) == {"mesh_assembly", "format", "amg"}


@pytest.mark.parametrize("form", ["assembled", "matrix_free"])
@pytest.mark.parametrize("rhs", ["rhs", "load"])
def test_fem_poisson_entry_matches_jax(form, rhs):
    prob, step, mf, b, st = port_poisson()
    run = step if form == "assembled" else mf
    bv = b if rhs == "rhs" else step.load
    ref, _, _ = jax_poisson(((rhs, tuple(bv.numpy())),))
    jit, jx, jconv = ref[rhs]
    res = run(bv, st)
    assert bool(res.converged) and jconv
    slack = 0 if form == "assembled" else 1
    assert abs(res.iters - jit) <= slack, (res.iters, jit)
    x = res.x.numpy()
    assert np.abs(x - jx).max() / np.abs(jx).max() <= ENTRY_X_TOL
    if rhs == "load":
        # the manufactured solution at h = 1/8 (O(h²): 2.6e-2 here; the
        # JAX package's own 3-D test allows 5e-2 at h = 1/6)
        n = prob.kii.shape[0]
        assert np.abs(x[:n] - prob.exact).max() < 5e-2


def test_fem_matrix_free_apply_is_k_ii():
    prob, step, mf, b, _ = port_poisson()
    assert set(mf.setup) == {"mesh_assembly", "elements"}
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (b.shape[0], 2)))
    n = prob.kii.shape[0]
    x[n:] = 0.0
    want = prob.kii.to_dense() @ x[:n].numpy()
    got = mf.apply(x)
    np.testing.assert_allclose(got[:n].numpy(), want, rtol=1e-13,
                               atol=1e-13 * np.abs(want).max())
    assert b.shape[0] > n and not got[n:].any()  # zero pad rows
    np.testing.assert_allclose(mf.apply(x[:, 0]).numpy(),
                               step.apply(x[:, 0]).numpy(), rtol=1e-13,
                               atol=1e-13 * np.abs(want).max())


def test_fem_poisson_entry_refuses_a_foreign_hierarchy():
    prob, step, _, _, _ = port_poisson()
    small = fem_poisson_problem((4, 4, 4))
    with pytest.raises(ValueError, match="fine level"):
        fem_poisson_entry((4, 4, 4), amg=step.preconditioner, problem=small)


def test_fem_poisson_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fem_poisson_entry(problem=fem_poisson_problem((3, 3, 3)))


def test_exports_match_jax_but_phalanx():
    import trilinos_tpu.io as jio
    import trilinos_tpu_torch.io as tio

    # Phalanx's names came with the nonlinear layer: the exports now match
    assert set(fem.__all__) == set(jfem.__all__)
    assert set(jio.__all__) <= set(tio.__all__)
