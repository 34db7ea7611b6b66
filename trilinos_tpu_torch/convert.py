"""Carry the JAX package's operators and AMG state into the port.

The functions here take numpy arrays and plain fields — never JAX objects
by type — so both packages can apply the same hierarchy: a caller turns
every array of the JAX package's ``SaAmg.state()`` into numpy (for example
with ``jax.tree_util.tree_map(np.asarray, state)``) and hands it to
:func:`amg_state_from_jax`, or the same of a ``BlockStructuredAmg.state()``
to :func:`block_amg_state_from_jax`. bfloat16 arrays are widened to float32
on the host (exact) and narrowed back on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .ops.formats import (BdiaMatrix, BsrMatrix, CsrHost, DiaMatrix,
                          EllMatrix, dia_from_host)
from .ops.stencil_op import StencilOp
from .precond.amg import structured_block
from .precond.direct_prec import DirectPrec
from .precond.ilu import Ilu0
from .precond.ilut import Ilut
from .precond.jacobi import Relaxation
from .precond.schwarz import AdditiveSchwarz
from .precond.two_level_schwarz import TwoLevelSchwarz
from .precond.poly import GmresPoly
from .solvers.gcrodr import RecycleSpace
from .solvers.rcg import CgRecycleSpace


def _to_device(arr, device) -> torch.Tensor:
    """A tensor on ``device`` with ``arr``'s values and element type
    (float32, float64 or bfloat16)."""
    arr = np.array(arr)  # a writable copy: torch wraps it without copying
    if arr.dtype.name == "bfloat16":
        # torch reads no numpy bfloat16; the widening to f32 is exact
        return torch.from_numpy(arr.astype(np.float32)).to(
            resolve_device(device), torch.bfloat16)
    return torch.from_numpy(arr).to(resolve_device(device))


def dia_from_numpy(data, offsets, n_rows: int, n_cols: int, nnz: int,
                   device=None) -> DiaMatrix:
    """A DiaMatrix from diagonals stored ``(nd, n_rows_pad)`` or in the JAX
    package's lane-packed ``(nd, n_rows_pad // 128, 128)`` layout. The
    element type is kept: float32, float64 or bfloat16."""
    data = np.array(data)  # a writable copy: torch wraps it without copying
    data = data.reshape(data.shape[0], -1)
    if data.dtype.name == "bfloat16":
        return DiaMatrix(data=_to_device(data, device),
                         offsets=tuple(int(o) for o in offsets),
                         n_rows=n_rows, n_cols=n_cols, nnz=nnz)
    return dia_from_host(data, offsets, n_rows, n_cols, nnz, data.dtype,
                         device)


def bdia_from_numpy(data, offsets, block_size: int, n_rows: int, n_cols: int,
                    nnz: int, device=None) -> BdiaMatrix:
    """A BdiaMatrix from planes stored ``(nd, b, b, nbr_pad)`` or in the JAX
    package's lane-packed ``(nd·b², nbr_pad // 128, 128)`` layout. The
    element type is kept: float32, float64 or bfloat16."""
    data = np.asarray(data)
    b = int(block_size)
    nd = len(offsets)
    if data.size % (nd * b * b):
        raise ValueError(f"BDIA data of shape {data.shape} does not hold "
                         f"{nd} offsets of {b}x{b} blocks")
    t = _to_device(data.reshape(nd, b, b, -1), device)
    return BdiaMatrix(data=t, offsets=tuple(int(o) for o in offsets),
                      block_size=b, n_rows=int(n_rows), n_cols=int(n_cols),
                      nnz=int(nnz))


def ell_from_numpy(cols, vals, n_rows: int, n_cols: int, nnz: int,
                   device=None) -> EllMatrix:
    """An EllMatrix from its (n_rows_pad, k) column and value arrays."""
    return EllMatrix(cols=torch.from_numpy(np.array(cols, np.int64)).to(
        resolve_device(device)), vals=_to_device(vals, device),
        n_rows=int(n_rows), n_cols=int(n_cols), nnz=int(nnz))


def bsr_from_numpy(bcols, bvals, block_size: int, n_rows: int, n_cols: int,
                   nnz: int, device=None) -> BsrMatrix:
    """A BsrMatrix from its (n_brows_pad, kb) block columns and
    (n_brows_pad, kb, b, b) blocks."""
    return BsrMatrix(bcols=torch.from_numpy(np.array(bcols, np.int64)).to(
        resolve_device(device)), bvals=_to_device(bvals, device),
        block_size=int(block_size), n_rows=int(n_rows), n_cols=int(n_cols),
        nnz=int(nnz))


def stored_from_numpy(m, device=None):
    """The port's form of one of the JAX package's stored matrices whose
    arrays are numpy: a DIA (2-D or lane-packed data), BDIA, ELL or BSR
    matrix, told apart by its fields."""
    if hasattr(m, "block_size") and hasattr(m, "offsets"):
        return bdia_from_numpy(m.data, m.offsets, m.block_size, m.n_rows,
                               m.n_cols, m.nnz, device)
    if hasattr(m, "offsets"):
        return dia_from_numpy(m.data, m.offsets, m.n_rows, m.n_cols, m.nnz,
                              device)
    if hasattr(m, "bcols"):
        return bsr_from_numpy(m.bcols, m.bvals, m.block_size, m.n_rows,
                              m.n_cols, m.nnz, device)
    if hasattr(m, "cols") and hasattr(m, "vals"):
        return ell_from_numpy(m.cols, m.vals, m.n_rows, m.n_cols, m.nnz,
                              device)
    raise TypeError(f"no stored form for {type(m).__name__}")


def ilu_from_numpy(a: CsrHost, l, u, udinv, sweeps: int, params=None,
                   ilut: bool = False, device=None) -> Ilu0:
    """A computed port ``Ilu0`` (``Ilut`` with ``ilut``) on host matrix
    ``a`` whose state is the JAX one's: its factors ``_l`` and ``_u`` (DIA
    or ELL, arrays numpy), ``_udinv`` and ``sweeps``."""
    m = (Ilut if ilut else Ilu0)(a, params, device=device).initialize()
    m.set_state(stored_from_numpy(l, device), stored_from_numpy(u, device),
                _to_device(udinv, device), int(sweeps))
    return m


def schwarz_from_numpy(a: CsrHost, inv, gather, weight, params=None,
                       device=None) -> AdditiveSchwarz:
    """A computed port ``AdditiveSchwarz`` on host matrix ``a`` whose state
    is the JAX one's ``inv``, ``gather`` and ``weight``."""
    m = AdditiveSchwarz(a, params, device=device).initialize()
    m.set_state(_to_device(inv, device),
                _to_device(np.asarray(gather, np.int64), device),
                _to_device(weight, device))
    return m


def direct_prec_from_numpy(a: CsrHost, inv_dense, params=None,
                           device=None) -> DirectPrec:
    """A computed port ``DirectPrec`` on host matrix ``a`` whose state is
    the JAX one's padded dense inverse ``inv_dense``."""
    m = DirectPrec(a, params, device=device).initialize()
    m.set_state(_to_device(inv_dense, device))
    return m


def two_level_schwarz_from_numpy(a: CsrHost, phi, a0_inv, inv, gather,
                                 weight, params=None,
                                 device=None) -> TwoLevelSchwarz:
    """A computed port ``TwoLevelSchwarz`` on host matrix ``a`` whose state
    is the JAX one's: the padded coarse basis ``phi``, ``a0_inv`` and its
    first level's ``inv``, ``gather`` and ``weight``."""
    m = TwoLevelSchwarz(a, params, device=device).initialize()
    p = m.params
    level1 = schwarz_from_numpy(a, inv, gather, weight, {
        "schwarz: num subdomains": p["schwarz: num subdomains"],
        "schwarz: overlap level": p["schwarz: overlap level"],
        "schwarz: combine mode": p["schwarz: combine mode"],
        "schwarz: subdomain ids": p["schwarz: subdomain ids"],
        "dtype": p["dtype"]}, device)
    m.set_state(level1, _to_device(phi, device), _to_device(a0_inv, device))
    return m


def relaxation_from_numpy(a: CsrHost, dinv, omega: float, sweeps: int,
                          params=None, device=None) -> Relaxation:
    """A computed port ``Relaxation`` on host matrix ``a`` whose state is
    the given padded inverse diagonal, damping factor and sweep count (the
    JAX one's ``dinv``, ``omega`` and ``sweeps``); more than one sweep packs
    ``a`` with ``choose_format`` in dinv's dtype, as ``compute()`` does."""
    m = Relaxation(a, params, device=device).initialize()
    m.set_state(_to_device(dinv, device), omega, sweeps)
    return m


def stencil_from_fields(dims, offsets, coeffs, n_rows_pad: int,
                        dtype="float32") -> StencilOp:
    """The port's StencilOp with the fields of the JAX package's one."""
    return StencilOp(dims=tuple(int(d) for d in dims),
                     offsets=tuple(tuple(int(o) for o in off)
                                   for off in offsets),
                     coeffs=tuple(float(c) for c in coeffs),
                     n_rows_pad=int(n_rows_pad), dtype=str(dtype))


def _level_dims(dims, n_levels: int):
    """Grid dims of each level of a structured hierarchy on ``dims``."""
    out = [tuple(int(d) for d in dims) + (1,) * (3 - len(dims))]
    for _ in range(n_levels - 1):
        block = structured_block(out[-1])
        out.append(tuple(d // b for d, b in zip(out[-1], block)))
    return out


def amg_state_from_jax(np_state: dict, dims, device=None) -> dict:
    """The port's ``SaAmg.state()`` from the JAX package's one with every
    array already numpy. ``dims`` is the fine grid; each level's operator
    is checked against the grid it must cover on that hierarchy."""
    levels = []
    grid = _level_dims(dims, len(np_state["levels"]))
    for s, g in zip(np_state["levels"], grid, strict=True):
        a = s["a"]
        if hasattr(a, "coeffs"):
            a_t = stencil_from_fields(a.dims, a.offsets, a.coeffs,
                                      a.n_rows_pad, a.dtype)
            if a_t.dims != g:
                raise ValueError(f"level stencil on {a_t.dims}, "
                                 f"expected grid {g}")
        else:
            a_t = dia_from_numpy(a.data, a.offsets, a.n_rows, a.n_cols,
                                 a.nnz, device)
            if a_t.n_rows != int(np.prod(g)):
                raise ValueError(f"level DIA has {a_t.n_rows} rows, "
                                 f"expected grid {g}")
        levels.append({"a": a_t, "dinv": torch.from_numpy(
            np.array(s["dinv"])).to(resolve_device(device))})
    coarse_inv = torch.from_numpy(np.array(np_state["coarse_inv"]))
    return {"levels": levels,
            "coarse_inv": coarse_inv.to(resolve_device(device))}


def uncoupled_amg_state_from_jax(np_state: dict, device=None) -> dict:
    """The port's uncoupled ``SaAmg.state()`` from the JAX package's one
    with every array already numpy: each level's stored operator (DIA or
    ELL; a matrix-free stencil fine level keeps its fields), Jacobi
    diagonal and ELL ``p``/``pt``, and the coarse pseudo-inverse. Apply it
    with the ``apply_state`` of a port hierarchy built on the same matrix,
    which checks the level count."""
    levels = []
    for s in np_state["levels"]:
        a = s["a"]
        if hasattr(a, "coeffs"):
            a_t = stencil_from_fields(a.dims, a.offsets, a.coeffs,
                                      a.n_rows_pad, a.dtype)
        else:
            a_t = stored_from_numpy(a, device)
        levels.append({"a": a_t, "dinv": _to_device(s["dinv"], device),
                       "p": stored_from_numpy(s["p"], device),
                       "pt": stored_from_numpy(s["pt"], device)})
    return {"levels": levels,
            "coarse_inv": _to_device(np_state["coarse_inv"], device)}


def block_amg_state_from_jax(np_state: dict, device=None) -> dict:
    """The port's ``BlockStructuredAmg.state()`` from the JAX package's one
    with every array already numpy: each level's BDIA operator (3-D
    lane-packed or 4-D data), Jacobi diagonal and tentative blocks ``q``,
    and the coarse pseudo-inverse. Apply it with the ``apply_state`` of a
    port hierarchy built on the same problem, which checks the level
    count."""
    levels = []
    for s in np_state["levels"]:
        a = s["a"]
        levels.append({
            "a": bdia_from_numpy(a.data, a.offsets, a.block_size, a.n_rows,
                                 a.n_cols, a.nnz, device),
            "dinv": _to_device(s["dinv"], device),
            "q": _to_device(s["q"], device)})
    return {"levels": levels,
            "coarse_inv": _to_device(np_state["coarse_inv"], device)}


def recycle_space_from_numpy(u, c, device=None) -> RecycleSpace:
    """A GCRO-DR ``RecycleSpace`` (U, C = A U with CᵀC = I) from the JAX
    package's ``u`` and ``c`` arrays; None arrays give an empty space."""
    if u is None:
        return RecycleSpace()
    return RecycleSpace(_to_device(u, device), _to_device(c, device))


def cg_recycle_space_from_numpy(u, device=None) -> CgRecycleSpace:
    """An RCG ``CgRecycleSpace`` from the JAX package's ``u``: ``rcg`` maps
    a given space onto its operator again (A U and (UᵀAU)⁻¹), so U alone
    carries it."""
    if u is None:
        return CgRecycleSpace()
    return CgRecycleSpace(_to_device(u, device))


def gmres_poly_from_numpy(a: CsrHost, h, y, degree: int, params=None,
                          device=None) -> GmresPoly:
    """A computed port ``GmresPoly`` on host matrix ``a`` whose polynomial
    is the given Hessenberg ``h``, coefficients ``y`` and degree (the JAX
    one's ``h``, ``y`` and ``degree``); ``a`` is packed with
    ``choose_format`` as ``compute()`` packs it, in the ``"dtype"``
    parameter's type."""
    m = GmresPoly(a, params, device=device).initialize()
    m.set_state(np.asarray(h, np.float64), np.asarray(y, np.float64),
                int(degree))
    return m


def _shard(m, s: int):
    """A plain view of shard s of a JAX package's stacked stored matrix
    whose arrays are numpy: every array field's row s, the rest as is."""
    import types

    fields = {k: (v[s] if isinstance(v, np.ndarray) else v)
              for k, v in vars(m).items()}
    return types.SimpleNamespace(**fields)


def dist_local_from_jax(obj, s: int, device=None):
    """Rank s's counterpart in the port of one of the JAX package's
    distributed objects whose array leaves are numpy (for example after
    ``jax.tree_util.tree_map(np.asarray, obj)``; shard s of every stacked
    leaf is taken):

    * a ``DistMatrix`` → ``parallel.distmatrix.LocalMatrix``;
    * a ``DistStencil`` → ``parallel.distmatrix.LocalStencil``;
    * a ``DistPrecond`` of kind identity, jacobi, ilu0, schwarz,
      chebyshev, amg or cheb_fused → ``parallel.driver.LocalPrecond`` (its ``make(comm, op)``
      is the rank's apply). The structured AMG's state is a single-card
      hierarchy object in the port, built by ``dist_amg_structured``;
      it has no conversion.
    """
    from .parallel.distmatrix import (BoundaryPart, HaloPlan, LocalMatrix,
                                      LocalStencil, _tensor)
    from .parallel.driver import LocalPrecond

    dev = resolve_device(device)

    def plan(p):
        return HaloPlan(send_idx=_tensor(p.send_idx[s], dev),
                        send_valid=_tensor(p.send_valid[s], dev),
                        recv_sel=_tensor(p.recv_sel[s], dev),
                        ghost_valid=_tensor(p.ghost_valid[s], dev),
                        n_ghost_pad=int(p.n_ghost_pad), seg=int(p.seg),
                        mode=str(p.mode),
                        offsets=tuple(int(o) for o in p.offsets))

    def matrix(m):
        it = stored_from_numpy(_shard(m.interior, s), dev)
        bd = BoundaryPart(rows_idx=_tensor(m.boundary.rows_idx[s], dev),
                          cols=_tensor(m.boundary.cols[s], dev),
                          vals=_to_device(m.boundary.vals[s], dev))
        return LocalMatrix(interior=it, boundary=bd, plan=plan(m.plan),
                           row_map=_map(m.row_map), col_map=_map(m.col_map),
                           rank=s)

    def stencil(ds):
        op = ds.op_local
        return LocalStencil(
            plan=plan(ds.plan), sel=_tensor(ds.sel[s], dev),
            valid=_tensor(ds.valid[s], dev),
            op_local=stencil_from_fields(op.dims, op.offsets, op.coeffs,
                                         op.n_rows_pad, op.dtype),
            row_map=_map(ds.row_map), depth=int(ds.depth), rank=s)

    kind = getattr(obj, "kind", None)
    if kind is None:
        return stencil(obj) if hasattr(obj, "op_local") else matrix(obj)
    arr = obj.arrays
    if kind == "identity":
        return LocalPrecond({}, {}, kind)
    if kind in ("jacobi", "chebyshev"):
        return LocalPrecond({"dinv": _to_device(arr["dinv"][s], dev)}, {},
                            kind, tuple(obj.consts))
    if kind in ("ilu0", "schwarz"):
        local = {k: _tensor(arr[k][s], dev) if "cols" in k
                 else _to_device(arr[k][s], dev)
                 for k in ("l_cols", "l_vals", "u_cols", "u_vals", "udinv")}
        consts = (int(obj.consts[0]),)  # sweeps
        if kind == "schwarz":
            local["plan"] = plan(arr["plan"])
            consts += (str(obj.consts[1]), int(obj.consts[2]))
        return LocalPrecond(local, {}, kind, consts)
    if kind == "amg":
        levels = [{"a": matrix(lv["a"]), "p": matrix(lv["p"]),
                   "r": matrix(lv["r"]),
                   "dinv": _to_device(lv["dinv"][s], dev)}
                  for lv in arr["levels"]]
        return LocalPrecond(
            {"levels": levels},
            {"coarse_inv": _to_device(arr["coarse_inv"][s], dev),
             "coarse_pos": _tensor(arr["coarse_pos"][s], dev)},
            kind, tuple(obj.consts))
    if kind == "cheb_fused":
        stages, op, npl, off = obj.consts
        op_t = stencil_from_fields(op.dims, op.offsets, op.coeffs,
                                   op.n_rows_pad, op.dtype)
        return LocalPrecond(
            {"plan": plan(arr["plan"]), "sel": _tensor(arr["sel"][s], dev),
             "valid": _tensor(arr["valid"][s], dev),
             "zb": _tensor(arr["zb"][s], dev)}, {}, kind,
            (tuple(tuple(float(c) for c in st) for st in stages), op_t,
             int(npl), int(off)))
    raise NotImplementedError(f"no conversion for DistPrecond kind {kind!r}")


def _map(m):
    """The port's Map with the fields of the JAX package's one."""
    from .parallel.map import Map

    if m is None:
        return None
    return Map(n_global=int(m.n_global), n_shards=int(m.n_shards),
               n_local_pad=int(m.n_local_pad),
               lows=None if m.lows is None else tuple(int(v)
                                                      for v in m.lows))
