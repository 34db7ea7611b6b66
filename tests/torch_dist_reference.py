"""The JAX package's side of the port's distributed tests, and the
gathering of the port's rank results.

The port's side runs in three rank groups, each spawned once a run
(``parallel.driver.launch``) and shared by every test file that reads it
(``torch_dist_tasks.shared``): ``ranks_port`` (a group of 4 and one of 8:
the applies, the Schwarz applies and LOBPCG), ``solve_port`` (4 ranks: the
Krylov solves and the s-step cases) and ``amg_port`` (4 ranks: the AMG
paths, the eigensolver cases, Schwarz GMRES and the entries). The JAX
side of each test file is a shared computation of its own, so that the
run's workers compute the groups and the references side by side:
``ranks_jax`` (one ``shard_map`` program a mesh size), ``jax_results``
(``dist_solve`` / ``dist_lsqr`` on a 4-device mesh), ``jax_sstep``,
``jax_eigen`` and ``jax_schwarz_gmres``; ``check_*`` are the files'
assertions.
"""
import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as PS

from trilinos_tpu import eigen as JE
from trilinos_tpu.galeri import laplace3d as jlaplace3d
from trilinos_tpu.io import matrix_market as jmm
from trilinos_tpu.ops.pallas.stencil_poly import chebyshev_stages as jcheb
from trilinos_tpu.ops import formats as F
from trilinos_tpu.parallel import dist_setup as jds
from trilinos_tpu.parallel import distmatrix as JD
from trilinos_tpu.parallel import driver as jdrv
from trilinos_tpu.parallel import mdarray as JMD
from trilinos_tpu.parallel.comm import AxisComm
from trilinos_tpu.parallel.solve_kinds import (
    run_all_eigen_kinds as jrun_all_eigen_kinds,
    run_all_solver_kinds as jrun_all_solver_kinds)
from trilinos_tpu.solvers import cg as jcg
from trilinos_tpu.solvers import factory as jfct
from trilinos_tpu.solvers import cg_pipeline as jcg_pipeline
from trilinos_tpu.solvers import cg_single_reduce as jcg_single_reduce
from trilinos_tpu.solvers import gmres as jgmres
from trilinos_tpu.solvers.pliris import dist_dense_solve as jdist_dense_solve
from trilinos_tpu_torch.entry import MD_CHEB_LMAX, MD_RTOL
from trilinos_tpu_torch.io import write_sparse
from trilinos_tpu_torch.parallel import driver as drv
from trilinos_tpu_torch.parallel.map import Map

import torch_dist_tasks as T

P = 4
X_TOL = 1e-8
# LSQR amplifies rounding: the JAX package's own test holds its
# distributed and serial LSQR to 1e-6
LSQR_X_TOL = 1e-6
TIMEOUT = 400.0
RANKS = (4, 8)  # the sizes of the spmv groups
JSOLVERS = {"cg": jcg, "gmres": jgmres}


def jcsr(a):
    return F.CsrHost(a.row_ptr, a.cols, a.vals, a.shape)


def _jax_prec(recipe, a, jdm):
    if recipe is None:
        return None
    kind, kw = recipe
    rmap = jdm.row_map
    if kind == "ilu0":
        return jdrv.dist_ilu0(a, rmap)
    if kind == "chebyshev":
        return jdrv.dist_chebyshev(a, rmap, **kw)
    if kind == "amg":
        return jdrv.dist_amg(a, rmap, **kw)
    return jdrv.dist_amg_blocks(jds.split_rows(a, rmap), rmap, **kw)


def _jax_case(name, mesh):
    """(host x, iterations, right-hand side or None) of case ``name``."""
    b = None
    if name in T.solve_problems():
        a, solver, kw, recipe = T.solve_problems()[name]
        ja = jcsr(a)
        dm = JD.distribute(ja, P)
        bg = jnp.asarray(dm.row_map.to_padded(T.vectors(a.shape[0], 1)))
        res = jdrv.dist_solve(JSOLVERS[solver], dm, bg, mesh=mesh,
                              prec=_jax_prec(recipe, ja, dm), **kw)
    elif name in T.STENCIL_CASES:
        dims, _, kw = T.STENCIL_CASES[name]
        op = jlaplace3d(*dims, dtype=np.float64, fmt="stencil")
        dm = JD.distribute_stencil(op, P)
        bg = jnp.asarray(dm.row_map.to_padded(T.vectors(op.n_rows, 1)))
        res = jdrv.dist_solve(jcg, dm, bg, mesh=mesh,
                              prec=jdrv.dist_cheb_fused(op, P, degree=4),
                              **kw)
    elif name == "lsqr":
        dm = JD.distribute(jcsr(T.nonsym_csr(2, T.LSQR_N)), P)
        bg = jnp.asarray(dm.row_map.to_padded(T.vectors(T.LSQR_N, 1)))
        res = jdrv.dist_lsqr(dm, bg, mesh=mesh, **T.LSQR_KW)
    elif name == "entry/pipelined_cg":
        # config 4 row-partitioned: DIA interiors, pipelined CG + jacobi
        ja = jlaplace3d(*T.ENTRY_DIMS["pipelined_cg"])
        dm = JD.distribute(ja, P, fmt="auto")
        b = np.random.default_rng(3).standard_normal(ja.shape[0])
        res = jdrv.dist_solve(jcg_pipeline, dm,
                              jnp.asarray(dm.row_map.to_padded(b)),
                              mesh=mesh,
                              prec=jdrv.dist_jacobi(ja, dm.row_map),
                              rtol=1e-8)
    else:
        # structured AMG-PCG on the z-slab stencil, entry()'s settings
        op = jlaplace3d(*T.ENTRY_DIMS["amg"], dtype=np.float64,
                        fmt="stencil")
        dm = JD.distribute_stencil(op, P)
        b = np.random.default_rng(0).standard_normal(op.n_rows)
        res = jdrv.dist_solve(jcg, dm, jnp.asarray(dm.row_map.to_padded(b)),
                              mesh=mesh,
                              prec=jdrv.dist_amg_structured(
                                  op, P, dtype=np.float64),
                              rtol=1e-5, maxiter=50)
    return dict(x=dm.row_map.from_padded(np.asarray(res.x)),
                iters=int(res.iters), b=b)


def jax_results(cases):
    mesh = jdrv.make_mesh(P)
    return {name: _jax_case(name, mesh) for name in cases}


def port_results(root, cases):
    """Each case's rank parts (``ranks``, in rank order) and, for a solve,
    the padded x and right-hand side gathered in rank order and every
    rank's iterations and convergence."""
    ranks = drv.launch(T.ranks_solve, P, list(cases), device="cpu",
                       rendezvous_dir=root, timeout=TIMEOUT)
    out = {}
    for name in cases:
        parts = [r[name] for r in ranks]
        out[name] = dict(ranks=parts)
        if isinstance(parts[0], dict) and "x" in parts[0]:
            out[name].update(xp=np.concatenate([q["x"] for q in parts]),
                             iters=[q["iters"] for q in parts],
                             converged=[q["converged"] for q in parts])
        if isinstance(parts[0], dict) and parts[0].get("b") is not None:
            out[name]["bp"] = np.concatenate([q["b"] for q in parts])
    return out


# the cases of the two 4-rank solve groups
SOLVE_GROUP = ("cg", "gmres_ilu0", "cg_chebyshev", "lsqr", "sstep/fused",
               "sstep/loop", "sstep/newton", "sstep/bf16")
AMG_GROUP = ("cg_amg", "cg_amg_blocks", "cg_cheb_fused",
             "entry/pipelined_cg", "entry/amg", "eigen/lobpcg_v0",
             "eigen/bks", "eigen/tracemin", "eigen/davidson", "eigen/rtr",
             "eigen/generalized_davidson", "eigen/global_op", "eigen/mass_refused", "schwarz/gmres",
             "entry/sstep", "entry/eigen")


def solve_port(tmp_path_factory):
    root = tmp_path_factory.getbasetemp()
    return T.shared("torch_dist_solve_port",
                    lambda: port_results(root, SOLVE_GROUP),
                    tmp_path_factory)


def amg_port(tmp_path_factory):
    root = tmp_path_factory.getbasetemp()
    return T.shared("torch_dist_amg_port",
                    lambda: port_results(root, AMG_GROUP), tmp_path_factory)


# -- the spmv groups of 4 and 8 ranks ----------------------------------------

def gather(ranks, key):
    return np.concatenate([r[key] for r in ranks])


def _ranks_mtx(root, side):
    """The distributed read's Matrix Market file, one for each side (the
    two sides may run at once in different workers)."""
    mtx = root / f"dist_read_{side}.mtx"
    write_sparse(mtx, T.nonsym_csr(4, 80))
    return mtx


def ranks_port(tmp_path_factory):
    """Every rank's parts from the group of 4 and the group of 8: the
    applies gathered in rank order (``name/op/label``, the Schwarz applies
    ``schwarz/mode/label``, the exchange modes), the bytes each rank
    staged, LOBPCG's result of each rank (``eigen/lobpcg``) and each
    rank's grid, mdarray and Pliris cases (``twins``)."""
    root = tmp_path_factory.getbasetemp()

    def compute():
        mtx = _ranks_mtx(root, "port")
        out = {}
        for p in RANKS:
            ranks = drv.launch(T.ranks_spmv, p, str(mtx), device="cpu",
                               rendezvous_dir=root, timeout=TIMEOUT)
            per_rank = ("staged", "eigen/lobpcg", "twins")
            got = {k: (ranks[0][k] if k.endswith("mode")
                       else gather(ranks, k))
                   for k in ranks[0] if k not in per_rank}
            for k in per_rank:
                got[k] = [r[k] for r in ranks]
            out[p] = got
        return out

    return T.shared("torch_dist_ranks_port", compute, tmp_path_factory)


def _ranks_jax_side(p, mtx):
    """Every apply reference of one group size from ONE shard_map program
    of the JAX package (its per-shard applies, exchange, combine and
    Schwarz applies), so its mesh compiles once."""
    mesh = jdrv.make_mesh(p)
    probs = T.spmv_problems()
    mats = {name: JD.distribute(jcsr(a), p) for name, a in probs.items()}
    lap = JD.distribute(jcsr(probs["laplace2d"]), p)
    jdr = jmm.read_sparse_distributed(str(mtx), p)
    sa = jcsr(T.laplace3d(*T.SCHWARZ_DIMS))
    sdm = JD.distribute(sa, p)
    precs = {mode: jdrv.dist_schwarz(sa, sdm.row_map, overlap=1,
                                     combine=mode)
             for mode in T.SCHWARZ_MODES}
    vecs = {}
    for name, a in probs.items():
        n = a.shape[0]
        for label, x in (("1d", T.vectors(n, 5)),
                         ("k4", T.vectors(n, 6, T.K))):
            vecs[f"{name}/{label}"] = jnp.asarray(
                mats[name].row_map.to_padded(x))
    vecs["combine"] = jnp.asarray(lap.row_map.to_padded(
        T.vectors(probs["laplace2d"].shape[0], 7)))
    vecs["read"] = jnp.asarray(jdr.row_map.to_padded(
        T.vectors(jdr.row_map.n_global, 8)))
    for label, x in (("1d", T.vectors(sa.shape[0], 9)),
                     ("k4", T.vectors(sa.shape[0], 10, T.K))):
        vecs[f"schwarz/{label}"] = jnp.asarray(sdm.row_map.to_padded(x))
    ms = dict(mats, combine=lap, read=jdr, schwarz=sdm)
    spec = {k: (PS(jdrv.AXIS) if v.ndim == 1 else PS(jdrv.AXIS, None))
            for k, v in vecs.items()}

    def body(m_sh, p_sh, v_sh):
        m = {k: JD.unstack_local(v) for k, v in m_sh.items()}
        out = {}
        for name in probs:
            for label in ("1d", "k4"):
                v = v_sh[f"{name}/{label}"]
                out[f"{name}/spmv/{label}"] = jdrv._local_op(m[name], p)(v)
                out[f"{name}/spmv_t/{label}"] = jdrv._local_op_t(
                    m[name], p)(v)
        x = v_sh["combine"]
        ghosts = JD.exchange(x, m["combine"].plan, jdrv.AXIS, p)
        for mode, scale in T.COMBINE_SCALES.items():
            out[f"combine/{mode}"] = JD.export_combine(
                x, ghosts * scale, m["combine"].plan, jdrv.AXIS, p,
                mode=mode)
        out["read/spmv"] = jdrv._local_op(m["read"], p)(v_sh["read"])
        comm = AxisComm(jdrv.AXIS, p)
        op = jdrv._local_op(m["schwarz"], p)
        for mode in T.SCHWARZ_MODES:
            apply = jdrv.DistPrecond(
                arrays=p_sh[mode], kind="schwarz",
                consts=precs[mode].consts).make(comm, op)
            for label in ("1d", "k4"):
                out[f"schwarz/{mode}/{label}"] = apply(
                    v_sh[f"schwarz/{label}"])
        return out

    out_spec = {**{f"{name}/{op}/{label}": spec[f"{name}/{label}"]
                   for name in probs for op in ("spmv", "spmv_t")
                   for label in ("1d", "k4")},
                **{f"combine/{mode}": spec["combine"]
                   for mode in T.COMBINE_SCALES},
                "read/spmv": spec["read"],
                **{f"schwarz/{mode}/{label}": spec[f"schwarz/{label}"]
                   for mode in T.SCHWARZ_MODES for label in ("1d", "k4")}}
    run = jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=({k: PS(jdrv.AXIS) for k in ms},
                  {mode: PS(jdrv.AXIS) for mode in precs}, spec),
        out_specs=out_spec))
    want = {k: np.asarray(v) for k, v in run(
        ms, {mode: pc.arrays for mode, pc in precs.items()}, vecs).items()}
    for name, jdm in mats.items():
        want[f"{name}/mode"] = jdm.plan.mode
    want["read/mode"] = jdr.plan.mode
    return want


def ranks_jax(tmp_path_factory):
    root = tmp_path_factory.getbasetemp()
    def compute():
        mtx = _ranks_mtx(root, "jax")
        return {p: _ranks_jax_side(p, mtx) for p in RANKS}

    return T.shared("torch_dist_ranks_jax", compute, tmp_path_factory)


def row_map(name):
    """The row map of case ``name`` (both packages build the same one)."""
    if name in T.solve_problems():
        n = T.solve_problems()[name][0].shape[0]
    elif name in T.STENCIL_CASES:
        n = int(np.prod(T.STENCIL_CASES[name][0]))
    elif name == "lsqr":
        n = T.LSQR_N
    else:
        n = int(np.prod(T.ENTRY_DIMS[name.split("/")[1]]))
    return Map.uniform(n, P)


def check_iterations(port, ref, case):
    its = port[case]["iters"]
    assert len(set(its)) == 1, its  # every rank ran the same iterations
    assert its[0] == ref[case]["iters"]
    assert all(port[case]["converged"])


def check_solution(port, ref, case):
    x = row_map(case).from_padded(port[case]["xp"])
    want = ref[case]["x"]
    err = np.abs(x - want).max() / np.abs(want).max()
    assert err <= (LSQR_X_TOL if case == "lsqr" else X_TOL), err


# -- s-step GMRES, the eigensolvers and Schwarz GMRES --------------------------

SSTEP_CASES = {
    # name → (grid, dtype, keywords, right-hand side seed, extra keywords)
    "fused": (T.SSTEP_DIMS, np.float32, T.SSTEP_KW, 42,
              dict(basis="fused")),
    "loop": (T.SSTEP_DIMS, np.float32, T.SSTEP_KW, 42, dict(basis="loop")),
    "newton": (T.SSTEP_DIMS, np.float64, T.SSTEP_NEWTON_KW, 42,
               dict(shifts=T.SSTEP_NEWTON_SHIFTS)),
}
# the JAX package's loop basis is its fused basis's arithmetic with one
# exchange an apply (its own tests/test_dist_stencil.py holds the two to
# the same count and residual): the port's loop case is held to its
# fused run, so one program less compiles
JAX_SSTEP_REF = {"fused": "fused", "loop": "fused", "newton": "newton"}


def jax_sstep():
    """The JAX package's dist_sstep_gmres on the fused and Newton s-step
    cases: iterations, residual norm, convergence and the unpadded x."""
    mesh = jdrv.make_mesh(P)

    def one(name):
        dims, dtype, kw, seed, extra = SSTEP_CASES[name]
        op = jlaplace3d(*dims, dtype=dtype, fmt="stencil")
        b = np.zeros(op.n_rows_pad, dtype)
        b[:op.n_rows] = T.vectors(op.n_rows, seed)
        res = jdrv.dist_sstep_gmres(op, jnp.asarray(b), mesh=mesh, **kw,
                                    **extra)
        return dict(iters=int(res.iters), resnorm=float(res.resnorm),
                    converged=bool(res.converged),
                    x=np.asarray(res.x)[:op.n_rows])

    return {name: one(name) for name in sorted(set(JAX_SSTEP_REF.values()))}


def jax_eigen():
    """The JAX package's dist_eigsolve on each eigensolver case (LOBPCG on
    4 and on 8 shards, the others on 4): eigenvalues and iterations;
    ``global_op``: its global_operator's applies; ``mass_refused``: the
    message of its ValueError."""
    meshes = {p: jdrv.make_mesh(p) for p in RANKS}

    def one(key):
        name, p = key
        grid, nev, solver, kw = T.EIGEN_CASES[name]
        a = jcsr(T.laplace2d(*grid))
        dm = JD.distribute(a, p)
        kw = dict(kw)
        if name == "davidson":
            kw["prec"] = jdrv.dist_jacobi(a, dm.row_map)
        v0 = T.lobpcg_v0(a.shape[0]) if name == "lobpcg_v0" else None
        res = jdrv.dist_eigsolve(getattr(JE, solver), dm, nev,
                                 mesh=meshes[p], v0=v0, **kw)
        return dict(vals=np.asarray(res.eigenvalues), iters=int(res.iters))

    keys = [(name, p) for name in T.EIGEN_CASES
            for p in (RANKS if name == "lobpcg" else (P,))]
    out = {key: one(key) for key in keys}
    a = jcsr(T.laplace2d(*T.GLOBAL_OP_GRID))
    dm = JD.distribute(a, P)
    op = jdrv.global_operator(dm, meshes[P])
    n = a.shape[0]
    out["global_op"] = {
        label: dm.row_map.from_padded(np.asarray(op(jnp.asarray(
            dm.row_map.to_padded(x)))))
        for label, x in (("1d", T.vectors(n, 12)),
                         ("k4", T.vectors(n, 13, T.K)))}
    try:
        jdrv.dist_eigsolve(JE.lanczos_eigs, dm, 2, mesh=meshes[P],
                           mass_matrix=dm, dtype=np.float64)
        out["mass_refused"] = None
    except ValueError as err:
        out["mass_refused"] = str(err)
    return out


def jax_schwarz_gmres():
    """The JAX package's GMRES(30) with restricted Schwarz (overlap 1) on
    the Schwarz twin's grid with the entry's seed-3 right-hand side:
    iterations and the unpadded x."""
    a = jcsr(T.laplace3d(*T.SCHWARZ_DIMS))
    dm = JD.distribute(a, P)
    b = np.random.default_rng(3).standard_normal(a.shape[0])
    res = jdrv.dist_solve(
        jgmres, dm, jnp.asarray(dm.row_map.to_padded(b)),
        mesh=jdrv.make_mesh(P),
        prec=jdrv.dist_schwarz(a, dm.row_map, overlap=1, combine="ZERO"),
        restart=30, rtol=1e-8, maxiter=1000)
    return dict(iters=int(res.iters), b=b,
                x=dm.row_map.from_padded(np.asarray(res.x)))


# -- rank grids, mdarray and Pliris (the twins' JAX sides) ------------------

def twins(port, key):
    """Each rank's ``key`` case group from the group of 8 (the md entry's
    and the dryrun's from the group of 4)."""
    p = 4 if key in ("md_entry", "dryrun") else 8
    return [r[key] for r in port[p]["twins"]]


def jax_solver_kinds(kinds):
    """The JAX package's solver gate on its 4-device mesh
    (``run_all_solver_kinds(4)``) over ``kinds`` only: its factory table
    is cut to their names for the call, so that the gate's kinds can be
    computed in parts by several workers at once. Each kind's iterations,
    residual norms and unpadded x."""
    rmap = JD.distribute(jcsr(T.laplace2d(12, 2 * P)), P).row_map

    def unpad(x):
        x = np.asarray(x)
        if x.ndim == 1:
            return rmap.from_padded(x)
        return np.stack([rmap.from_padded(x[:, j])
                         for j in range(x.shape[1])], axis=1)

    saved = dict(jfct.ALIASES)
    jfct.ALIASES.clear()
    jfct.ALIASES.update({a: k for a, k in saved.items() if k in kinds})
    try:
        results = jrun_all_solver_kinds(P)
    finally:
        jfct.ALIASES.clear()
        jfct.ALIASES.update(saved)
    return {k: dict(iters=int(r.iters), x=unpad(r.x),
                    resnorm=np.asarray(r.resnorm))
            for k, r in results.items()}


def jax_eigen_kinds():
    """The JAX package's eigensolver gate on its 4-device mesh
    (``run_all_eigen_kinds(4)``): each kind's eigenvalues."""
    return {k: np.asarray(r[0] if isinstance(r, tuple) else r.eigenvalues)
            for k, r in jrun_all_eigen_kinds(P).items()}


def jax_grid():
    """The JAX package's two-level (2, 4) mesh on the grid twin's problem:
    ``solve_axes`` and each solve's iterations and unpadded x."""
    a = jcsr(T.laplace2d(*T.GRID_LAPLACE))
    dm = JD.distribute(a, 8)
    mesh2 = jdrv.make_mesh2(*T.GRID_SHAPE)
    bg = jnp.asarray(dm.row_map.to_padded(T.vectors(a.shape[0], 21)))
    runs = {"cg": lambda: jdrv.dist_solve(
                jcg, dm, bg, mesh=mesh2,
                prec=jdrv.dist_jacobi(a, dm.row_map), **T.GRID_KW["cg"]),
            "gmres": lambda: jdrv.dist_solve(jgmres, dm, bg, mesh=mesh2,
                                             **T.GRID_KW["gmres"]),
            "lsqr": lambda: jdrv.dist_lsqr(dm, bg, mesh=mesh2,
                                           **T.GRID_KW["lsqr"])}
    out = {"solve_axes": (jdrv.solve_axes(mesh2),
                          jdrv.solve_axes(jdrv.make_mesh(8)))}
    for name, run in runs.items():
        res = run()
        out[name] = dict(iters=int(res.iters),
                         x=dm.row_map.from_padded(np.asarray(res.x)))
    return out


def _mesh(shape, axes):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), axes)


def jax_md():
    """The JAX package's mdarray on the twin's cases: the applies, the md
    dot, the md solves' iterations and x, the CA sweeps and the md entry's
    solve on a (2, 2, 1) mesh."""
    m2 = _mesh((2, 4), ("x", "y"))
    out = {}
    for name, (shape, axes, halo, per, seed, fn) in T.MD_APPLIES.items():
        mdm = JMD.MDMap(shape, axes, halo=halo, periodic=per)
        out[name] = np.asarray(JMD.md_map_apply(mdm, m2, fn)(
            mdm.distribute(T.md_field(shape, seed), m2)))
    md = JMD.MDMap((16, 32), ("x", "y"), halo=(1, 1))
    rng = np.random.default_rng(5)
    fa, fb = rng.standard_normal((16, 32)), rng.standard_normal((16, 32))
    dot = jax.jit(jax.shard_map(JMD.md_dot(m2), mesh=m2,
                                in_specs=(md.spec(), md.spec()),
                                out_specs=PS()))
    out["md_dot"] = float(dot(md.distribute(fa, m2), md.distribute(fb, m2)))

    def solve(label, solver, mdm, mesh, fn, seed, **kw):
        res = JMD.md_solve(solver, mdm, mesh, fn, jnp.asarray(
            T.md_field(mdm.global_shape, seed)), **kw)
        out[label] = dict(iters=int(res.iters), x=np.asarray(res.x))

    solve("cg_2d", jcg, md, m2, T.lap5, 7, rtol=1e-12, maxiter=2000)
    solve("cg_3d", jcg_single_reduce,
          JMD.MDMap((8, 8, 16), ("x", "y", "z"), halo=(1, 1, 1)),
          _mesh((2, 2, 2), ("x", "y", "z")), T.lap7, 8, rtol=1e-12,
          maxiter=3000)
    s = len(T.MD_POLY_STAGES)
    for per in (False, True):
        deep = JMD.MDMap((16, 32), ("x", "y"), halo=(s, s),
                         periodic=(per, per))
        out[f"chained/{per}"] = np.asarray(JMD.md_poly_apply(
            deep, m2, T.lap5, T.MD_POLY_STAGES)(
                deep.distribute(T.md_field((16, 32), 11), m2)))
    ca = T.MD_CA
    prec = JMD.md_poly_local(
        JMD.MDMap((16, 32), ("x", "y"), halo=(ca["degree"],) * 2), m2,
        T.lap5, jcheb(ca["lmax"], ca["lmin"], ca["degree"], ca["dinv"]))
    solve("ca_cg", jcg, md, m2, T.lap5, 12, prec_local=prec, rtol=1e-11,
          maxiter=500)
    solve("ca_cg_plain", jcg, md, m2, T.lap5, 12, rtol=1e-11, maxiter=500)
    # dist_md_entry's solve: CG + degree-3 Chebyshev stages, halo 3
    dims, axes = T.MD_ENTRY_DIMS, ("x", "y", "z")
    m221 = _mesh((2, 2, 1), axes)
    stages = jcheb(MD_CHEB_LMAX, MD_CHEB_LMAX / 30.0, 3, 1.0 / 6.0)
    res = JMD.md_solve(
        jcg, JMD.MDMap(dims, axes, halo=(1, 1, 1)), m221, T.lap7,
        jnp.asarray(np.random.default_rng(0).standard_normal(dims)),
        prec_local=JMD.md_poly_local(JMD.MDMap(dims, axes, halo=(3, 3, 3)),
                                     m221, T.lap7, stages),
        rtol=MD_RTOL, maxiter=2000)
    out["md_entry"] = dict(iters=int(res.iters), x=np.asarray(res.x))
    return out


def jax_pliris():
    """The JAX package's dist_dense_solve on an 8-device mesh, each twin
    case."""
    mesh = Mesh(np.array(jax.devices()[:8]), ("cols",))
    return {name: np.asarray(jdist_dense_solve(
                mesh, *T.pliris_system(n, seed, piv, k), nb=nb))
            for name, (n, nb, seed, piv, k) in T.PLIRIS_CASES.items()}
