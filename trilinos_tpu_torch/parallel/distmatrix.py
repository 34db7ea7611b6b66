"""Distributed sparse matrices: row-partitioned storage and halo exchange.

Counterpart of ``trilinos_tpu/parallel/distmatrix.py``, the fusion of the
reference's Import/Export + Distributor + CrsMatrix::apply:

* plan construction (``Tpetra::Import`` setup and
  ``Distributor::createFromRecvs``) runs once on the host at
  :func:`distribute` (the fillComplete moment). Every rank's arrays are
  built there, as numpy, stacked on a leading rank axis exactly as the JAX
  package stacks its shards (``HaloPlan``, ``BoundaryPart``) or kept as a
  list of the ranks' interiors, so a test can hold rank s's arrays against
  the JAX package's ``[s]``. Each rank builds them itself from the same
  host matrix and takes its own part with ``local(rank, device)``; nothing
  is broadcast;
* the ghost (column) ordering follows the reference's makeColMap: owned
  columns first, then remote GIDs grouped by owner, sorted within, which
  makes every receive buffer contiguous per neighbour;
* the exchange is ``all_to_all_single`` (general neighbour sets, mode
  ``a2a``) or one ``batch_isend_irecv`` per rank offset (at most four
  offsets, mode ``ppermute``: the banded stencil case);
* :func:`apply_local` splits the local matrix into an **interior** part
  (owned columns, the bandwidth-bound SpMV through the port's ``spmv``:
  DIA interiors reach ``dia_kernel``, multivectors ``dia_mv_kernel``) and
  a compact **boundary** part (rows that touch ghosts, an ELL gather and
  einsum in plain torch, as the JAX package computes it outside any
  kernel). It posts the exchange, runs the interior SpMV, and only then
  waits: the reference's doPosts/doWaits split, which the JAX package
  gets from XLA's scheduler.

All runtime functions take the rank's :class:`~.comm.Comm`; the transport
(and any staging through host memory) is the comm's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device, torch_dtype
from ..ops.formats import (BsrMatrix, CsrHost, DiaMatrix, EllMatrix,
                           ROW_ALIGN, csr_to_dia, csr_to_ell, pad_csr_square,
                           round_up)
from ..ops.matvec import spmv
from .comm import Comm, ProcessComm
from .map import Map


def _tensor(arr, device, dtype=None) -> torch.Tensor:
    """A torch tensor on ``device`` holding numpy ``arr`` (index arrays
    become int64)."""
    arr = np.asarray(arr)
    if arr.dtype.kind in "iu":
        arr = arr.astype(np.int64)
    arr = (np.ascontiguousarray(arr) if arr.flags.writeable
           else np.array(arr))  # torch wraps only writable arrays
    t = torch.from_numpy(arr).to(resolve_device(device))
    return t if dtype is None else t.to(torch_dtype(dtype))


def _move(m, device):
    """A port format object with its tensors on ``device``."""
    fields = {f.name: getattr(m, f.name) for f in dataclasses.fields(m)}
    return dataclasses.replace(m, **{
        k: v.to(resolve_device(device)) for k, v in fields.items()
        if isinstance(v, torch.Tensor)})


@dataclasses.dataclass(frozen=True, eq=False)
class HaloPlan:
    """Frozen exchange schedule. On the host every array has a leading rank
    axis; ``local(s, device)`` gives rank s's plan as tensors.

    send_idx:   (P, seg) local indices shipped to each peer
                (destination-major, gid-sorted within a destination)
    send_valid: (P, seg) bool, False on pad slots of send_idx
    recv_sel:   (g_pad,) position of each ghost slot in the flat receive
                buffer (mode-dependent layout)
    ghost_valid:(g_pad,) bool, False on pad ghost slots
    mode: 'a2a' (all-to-all over every rank) or 'ppermute' (one exchange
          per rank offset in ``offsets``)
    """

    send_idx: np.ndarray | torch.Tensor
    send_valid: np.ndarray | torch.Tensor
    recv_sel: np.ndarray | torch.Tensor
    ghost_valid: np.ndarray | torch.Tensor
    n_ghost_pad: int
    seg: int
    mode: str
    offsets: tuple[int, ...]

    def local(self, s: int, device) -> "HaloPlan":
        return dataclasses.replace(
            self, send_idx=_tensor(self.send_idx[s], device),
            send_valid=_tensor(self.send_valid[s], device),
            recv_sel=_tensor(self.recv_sel[s], device),
            ghost_valid=_tensor(self.ghost_valid[s], device))


@dataclasses.dataclass(frozen=True, eq=False)
class BoundaryPart:
    """Compact ELL over only the rows that reference ghosts; ``cols`` index
    into the extended vector [x_local | ghosts]. Host arrays carry a
    leading rank axis."""

    rows_idx: np.ndarray | torch.Tensor  # (nb_pad,) pad rows -> 0, vals 0
    cols: np.ndarray | torch.Tensor  # (nb_pad, kb)
    vals: np.ndarray | torch.Tensor  # (nb_pad, kb)

    def local(self, s: int, device, dtype) -> "BoundaryPart":
        return BoundaryPart(rows_idx=_tensor(self.rows_idx[s], device),
                            cols=_tensor(self.cols[s], device),
                            vals=_tensor(self.vals[s], device, dtype))


def _stack(parts):
    """Per-rank dataclasses of numpy arrays → one with stacked arrays."""
    first = parts[0]
    out = {}
    for f in dataclasses.fields(first):
        v = getattr(first, f.name)
        out[f.name] = (np.stack([getattr(p, f.name) for p in parts])
                       if isinstance(v, np.ndarray) else v)
    return dataclasses.replace(first, **out)


@dataclasses.dataclass(frozen=True, eq=False)
class LocalMatrix:
    """Rank ``rank``'s part of a :class:`DistMatrix`, on one device."""

    interior: DiaMatrix | EllMatrix | BsrMatrix
    boundary: BoundaryPart
    plan: HaloPlan
    row_map: Map
    col_map: Map | None
    rank: int

    @property
    def domain_map(self) -> Map:
        return self.col_map or self.row_map

    @property
    def device(self) -> torch.device:
        return self.boundary.vals.device


@dataclasses.dataclass(frozen=True, eq=False)
class DistMatrix:
    """Row-partitioned matrix on the host: ``interior[s]`` is rank s's
    interior (a port format object on the CPU), ``boundary`` and ``plan``
    hold every rank's arrays stacked. ``col_map`` is the domain map of a
    rectangular operator (AMG's P and R)."""

    interior: list
    boundary: BoundaryPart
    plan: HaloPlan
    row_map: Map
    col_map: Map | None = None

    @property
    def domain_map(self) -> Map:
        return self.col_map or self.row_map

    @property
    def dtype(self) -> torch.dtype:
        return self.interior[0].dtype

    def local(self, s: int, device=None) -> LocalMatrix:
        """Rank s's part with its tensors on ``device`` (``None``: the
        card)."""
        dev = resolve_device(device)
        return LocalMatrix(interior=_move(self.interior[s], dev),
                           boundary=self.boundary.local(s, dev, self.dtype),
                           plan=self.plan.local(s, dev),
                           row_map=self.row_map, col_map=self.col_map,
                           rank=s)


@dataclasses.dataclass(frozen=True, eq=False)
class LocalStencil:
    """Rank ``rank``'s part of a :class:`DistStencil`, on one device."""

    plan: HaloPlan
    sel: torch.Tensor
    valid: torch.Tensor
    op_local: object
    row_map: Map
    depth: int
    rank: int

    @property
    def device(self) -> torch.device:
        return self.sel.device


@dataclasses.dataclass(frozen=True, eq=False)
class DistStencil:
    """Matrix-free distributed stencil over a z-slab row partition: each
    rank owns nz/P whole z-planes; the halo plan ships the ``depth``
    neighbouring planes; the local apply runs the stencil kernel on the
    extended slab (ghost planes past the global faces stay zero, which is
    the Dirichlet truncation) and keeps the owned planes.

    sel:   (P, n_ext) index into [x_local | ghosts] per extended row
    valid: (P, n_ext) bool; False -> 0 (off-grid plane)
    """

    plan: HaloPlan
    sel: np.ndarray
    valid: np.ndarray
    op_local: object
    row_map: Map
    depth: int = 1

    def local(self, s: int, device=None) -> LocalStencil:
        dev = resolve_device(device)
        return LocalStencil(plan=self.plan.local(s, dev),
                            sel=_tensor(self.sel[s], dev),
                            valid=_tensor(self.valid[s], dev),
                            op_local=self.op_local, row_map=self.row_map,
                            depth=self.depth, rank=s)


# ---------------------------------------------------------------------------
# plan and matrix construction (host, fillComplete time)
# ---------------------------------------------------------------------------


def distribute_partitioned(a: CsrHost, n_shards: int, *,
                           partition="greedy", coords=None,
                           fmt: str = "auto", dtype=None):
    """Partition → renumber → distribute (the Zoltan2 + Import
    composition). ``partition``: 'rcb' (needs coords (n, d)), 'greedy'
    (graph BFS) or a precomputed (n,) part array. Returns (DistMatrix,
    Directory): the matrix is distributed in the permuted numbering; the
    Directory maps original row ids to (owner, lid), and its
    ``new_of_old`` reorders vectors (x_new = x_old[perm])."""
    from .map import Directory
    from .partition import (partition_greedy_graph, partition_rcb,
                            partition_to_permutation, permute_csr)

    if isinstance(partition, str):
        if partition == "rcb":
            if coords is None:
                raise ValueError("rcb partitioning needs coords (n, d)")
            part = partition_rcb(coords, n_shards)
        elif partition == "greedy":
            part = partition_greedy_graph(a, n_shards)
        else:
            raise ValueError(f"unknown partition {partition!r}")
    else:
        part = np.asarray(partition, dtype=np.int64)
    perm = partition_to_permutation(part)  # perm[new] = old
    a_p = permute_csr(a, perm)
    sizes = np.bincount(part, minlength=n_shards)
    rmap = Map.contiguous(sizes)
    dm = distribute(a_p, n_shards, fmt=fmt, dtype=dtype, rmap=rmap)
    new_of_old = np.empty(a.shape[0], dtype=np.int64)
    new_of_old[perm] = np.arange(a.shape[0])
    return dm, Directory(map=rmap, new_of_old=new_of_old)


def distribute_stencil(op, n_shards: int,
                       depth: int | None = None) -> DistStencil:
    """Split a global StencilOp into a DistStencil over z-slabs.

    ``depth`` (in z-planes) defaults to the stencil's z-reach; the
    communication-avoiding smoother passes degree·reach so one exchange
    feeds a whole fused polynomial sweep."""
    from ..ops.stencil_op import StencilOp

    nx, ny, nz = op.dims
    pxy = nx * ny
    if nz % n_shards != 0:
        raise ValueError(
            f"distribute_stencil needs nz ({nz}) divisible by n_shards "
            f"({n_shards}); pad the grid or use distribute() on the "
            f"stored form")
    nzl = nz // n_shards
    npl = nzl * pxy
    if npl % ROW_ALIGN != 0:
        raise ValueError("plane size must be ROW_ALIGN-aligned")
    n = op.n_rows
    rmap = Map.uniform(n, n_shards)
    assert rmap.n_local_pad == npl
    if depth is None:
        depth = max((abs(o[2]) for o in op.offsets), default=0)
        depth = max(depth, 1)

    ghosts_of = []
    for s in range(n_shards):
        lo, hi = s * npl, (s + 1) * npl
        g_lo = np.arange(max(lo - depth * pxy, 0), lo)
        g_hi = np.arange(hi, min(hi + depth * pxy, n))
        ghosts_of.append(np.concatenate([g_lo, g_hi]))
    plans, _ = build_halo_plans(ghosts_of, rmap, n_shards)

    op_loc = StencilOp(dims=(nx, ny, nzl + 2 * depth), offsets=op.offsets,
                       coeffs=op.coeffs,
                       n_rows_pad=(nzl + 2 * depth) * pxy, dtype=op.dtype)
    n_ext = op_loc.n_rows_pad
    sels, valids = [], []
    for s in range(n_shards):
        lo, hi = s * npl, (s + 1) * npl
        g = ghosts_of[s]
        gid = np.arange(lo - depth * pxy, hi + depth * pxy)
        sel = np.zeros(n_ext, dtype=np.int32)
        valid = np.zeros(n_ext, dtype=bool)
        owned = (gid >= lo) & (gid < hi)
        sel[owned] = (gid[owned] - lo).astype(np.int32)
        ghost = (~owned) & (gid >= 0) & (gid < n)
        # ghosts_of[s] is gid-sorted (owner-major == gid order for slabs)
        sel[ghost] = (npl + np.searchsorted(g, gid[ghost])).astype(np.int32)
        valid[owned | ghost] = True
        sels.append(sel)
        valids.append(valid)

    return DistStencil(plan=_stack(plans), sel=np.stack(sels),
                       valid=np.stack(valids), op_local=op_loc,
                       row_map=rmap, depth=depth)


def zslab_bounds(op, n_shards: int, depth: int) -> np.ndarray:
    """Per-rank valid z-plane range [lo, hi) in extended-slab plane
    coordinates: ghost planes past the global faces stay masked at every
    polynomial stage while interior cuts read real halo data. Shape
    (n_shards, 2) int32."""
    nz = op.dims[2]
    nzl = nz // n_shards
    nz_ext = nzl + 2 * depth
    return np.stack([
        [max(0, depth - s * nzl),
         min(nz_ext, nz - s * nzl + depth)]
        for s in range(n_shards)]).astype(np.int32)


#: cumulative count of halo-plan constructions (values-only refill paths
#: must not bump it — tested)
PLAN_BUILD_COUNT = 0


def build_halo_plans(ghosts_of, omap: Map, n_shards: int):
    """Per-rank HaloPlans (numpy, one list entry a rank) for arbitrary
    ghost sets.

    ghosts_of[s]: owner-major gid-sorted ghost gids rank s needs; ``omap``
    owns the ghosted index space. This is the Import construction /
    createFromRecvs handshake, run once on the host. Returns (plans,
    sends) — sends[s][t] = lids of rank s that rank t needs. The mode is
    'ppermute' when the sends use at most four rank offsets, else 'a2a'.
    """
    global PLAN_BUILD_COUNT
    PLAN_BUILD_COUNT += 1
    sends = [[np.zeros(0, np.int64) for _ in range(n_shards)]
             for _ in range(n_shards)]
    for t in range(n_shards):
        g = ghosts_of[t]
        if len(g) == 0:
            continue
        owners = omap.owner_of(g)
        for o in np.unique(owners):
            sends[int(o)][t] = omap.gid_to_lid(g[owners == o], int(o))

    seg = max((len(sends[s][t]) for s in range(n_shards)
               for t in range(n_shards)), default=0)
    seg = max(seg, 1)
    g_pad = round_up(max((len(g) for g in ghosts_of), default=0) or 1,
                     ROW_ALIGN)

    all_offs = sorted({(t - s) % n_shards
                       for s in range(n_shards) for t in range(n_shards)
                       if len(sends[s][t])})
    mode = "ppermute" if 0 < len(all_offs) <= 4 else "a2a"

    plans = []
    for s in range(n_shards):
        send_idx = np.zeros((n_shards, seg), dtype=np.int32)
        send_valid = np.zeros((n_shards, seg), dtype=bool)
        for t in range(n_shards):
            send_idx[t, : len(sends[s][t])] = sends[s][t]
            send_valid[t, : len(sends[s][t])] = True
        g = ghosts_of[s]
        recv_sel = np.zeros(g_pad, dtype=np.int32)
        ghost_valid = np.zeros(g_pad, dtype=bool)
        ghost_valid[: len(g)] = True
        if len(g):
            owners = omap.owner_of(g).astype(np.int64)
            # ghosts are owner-major gid-sorted, so each ghost's position
            # in its owner's send segment is its offset within the owner's
            # run
            uniq, starts = np.unique(owners, return_index=True)
            counts = np.diff(np.append(starts, len(g)))
            pos = np.arange(len(g)) - np.repeat(starts, counts)
            if mode == "a2a":
                lane = owners
            else:
                lut = np.zeros(n_shards, dtype=np.int64)
                for i, off in enumerate(all_offs):
                    lut[off] = i
                lane = lut[(s - owners) % n_shards]
            recv_sel[: len(g)] = (lane * seg + pos).astype(np.int32)
        plans.append(HaloPlan(
            send_idx=send_idx, send_valid=send_valid, recv_sel=recv_sel,
            ghost_valid=ghost_valid, n_ghost_pad=g_pad, seg=seg, mode=mode,
            offsets=tuple(all_offs)))
    return plans, sends


def _boundary_stats(trips):
    rows = trips[0]
    if len(rows) == 0:
        return 0, 0
    _, counts = np.unique(rows, return_counts=True)
    return len(counts), int(counts.max())


def _pack_boundary(trips, nb_pad, kb, npl_c, dtype):
    """Boundary COO triples (local row, ghost slot, value) packed into the
    compact BoundaryPart ELL (numpy)."""
    rows, slots, vals = trips
    rows_idx = np.zeros(nb_pad, dtype=np.int32)
    bcols = np.zeros((nb_pad, kb), dtype=np.int32)
    bvals = np.zeros((nb_pad, kb), dtype=dtype)
    if len(rows):
        order = np.lexsort((slots, rows))
        r_s, sl_s, v_s = rows[order], slots[order], vals[order]
        ur, starts = np.unique(r_s, return_index=True)
        counts = np.diff(np.append(starts, len(r_s)))
        j_idx = np.repeat(np.arange(len(ur)), counts)
        q_idx = np.arange(len(r_s)) - np.repeat(starts, counts)
        rows_idx[: len(ur)] = ur
        bcols[j_idx, q_idx] = npl_c + sl_s
        bvals[j_idx, q_idx] = v_s
    return BoundaryPart(rows_idx=rows_idx, cols=bcols, vals=bvals)


def _host_dtype(dtype) -> np.dtype:
    return np.dtype(np.float32) if torch_dtype(dtype) == torch.float32 \
        else np.dtype(np.float64)


def distribute_rect(a: CsrHost, row_map: Map, col_map: Map,
                    dtype=None) -> DistMatrix:
    """Row-partition a rectangular host CSR: rows by ``row_map``, the
    column (domain) space owned by ``col_map`` (AMG's P and R). The
    interior holds locally owned columns as ELL without identity padding;
    ghost columns get a halo plan over the column map."""
    assert a.shape[0] <= row_map.n_global and a.shape[1] <= col_map.n_global
    all_rows = a._rows()
    all_cols = a.cols.astype(np.int64)
    all_vals = a.vals

    def shard_coo(s):
        lo, hi = row_map.shard_lo(s), row_map.shard_hi(s)
        lo_r, hi_r = min(lo, a.shape[0]), min(hi, a.shape[0])
        sl = slice(a.row_ptr[lo_r], a.row_ptr[hi_r])
        return all_rows[sl] - lo, all_cols[sl], all_vals[sl]

    return _distribute_rect(shard_coo, row_map, col_map,
                            dtype or a.vals.dtype)


def distribute_rect_blocks(blocks, row_map: Map, col_map: Map,
                           dtype=None) -> DistMatrix:
    """``distribute_rect()`` from per-rank row blocks (``blocks[s]`` =
    rank s's owned rows, global columns in ``col_map``'s space) — no
    global assembly."""
    assert row_map.n_shards == len(blocks)

    def shard_coo(s):
        blk = blocks[s]
        return blk._rows(), blk.cols.astype(np.int64), blk.vals

    dtype = dtype or blocks[0].vals.dtype
    return _distribute_rect(shard_coo, row_map, col_map, dtype)


def _distribute_rect(shard_coo, row_map: Map, col_map: Map,
                     dtype) -> DistMatrix:
    n_shards = row_map.n_shards
    npl_r, npl_c = row_map.n_local_pad, col_map.n_local_pad
    hdt = _host_dtype(dtype)

    ghosts_of, interior_csr, boundary_coo = [], [], []
    for s in range(n_shards):
        lo, hi = row_map.shard_lo(s), row_map.shard_hi(s)
        rs_g, cs_g, vs_g = shard_coo(s)
        clo, chi = col_map.shard_lo(s), col_map.shard_hi(s)
        owned = (cs_g >= clo) & (cs_g < chi)
        interior_csr.append(CsrHost.from_coo(
            rs_g[owned], cs_g[owned] - clo, vs_g[owned],
            (hi - lo, npl_c), sum_duplicates=False))
        bc_rows = rs_g[~owned]
        bc_cols = cs_g[~owned]
        bc_vals = vs_g[~owned]
        ghost_gids = np.unique(bc_cols)
        owners = col_map.owner_of(ghost_gids)
        order = np.lexsort((ghost_gids, owners))
        ghost_gids = ghost_gids[order]
        ghosts_of.append(ghost_gids)
        sort_perm = np.argsort(ghost_gids, kind="stable")
        lookup = np.searchsorted(ghost_gids[sort_perm], bc_cols)
        bc_slots = sort_perm[lookup]
        boundary_coo.append((bc_rows, bc_slots, bc_vals))

    plans, _ = build_halo_plans(ghosts_of, col_map, n_shards)

    stats = [_boundary_stats(t) for t in boundary_coo]
    kb = max(max((c for _, c in stats), default=0), 1)
    nb_pad = round_up(max((r for r, _ in stats), default=0) or 1,
                      ROW_ALIGN)
    k_union = max(max(ic.max_row_length() for ic in interior_csr), 1)
    interiors, boundaries = [], []
    for s in range(n_shards):
        e = csr_to_ell(interior_csr[s], dtype=dtype, k=k_union,
                       n_rows_pad=npl_r, identity_pad_rows=False,
                       device="cpu")
        interiors.append(EllMatrix(cols=e.cols, vals=e.vals, n_rows=npl_r,
                                   n_cols=npl_c, nnz=0))
        boundaries.append(_pack_boundary(boundary_coo[s], nb_pad, kb,
                                         npl_c, hdt))
    return DistMatrix(interior=interiors, boundary=_stack(boundaries),
                      plan=_stack(plans), row_map=row_map, col_map=col_map)


def distribute(a: CsrHost, n_shards: int, fmt: str = "auto",
               dtype=None, rmap: Map | None = None,
               block_size: int = 1, debug: bool = False) -> DistMatrix:
    """Partition a square host CSR by rows over ``n_shards`` ranks and build
    the frozen halo plan (the fillComplete + Import construction).

    ``rmap`` overrides the default contiguous uniform map. ``fmt``: 'auto'
    (DIA at 32 interior diagonals or fewer, else ELL), 'dia', 'ell' or
    'bsr' with ``block_size`` (only the interior apply is blocked; the halo
    stays scalar, so one plan serves every format; every rank's rows and
    the local padding must be block-aligned). ``debug`` runs the
    plan-reciprocity checks of :func:`_debug_validate`."""
    n = a.shape[0]
    assert a.shape[0] == a.shape[1], "distribute() requires square A"
    rmap = rmap or Map.uniform(n, n_shards)
    assert rmap.n_shards == n_shards and rmap.n_global == n

    all_rows = a._rows()
    all_cols = a.cols.astype(np.int64)
    all_vals = a.vals

    def shard_coo(s):
        lo, hi = rmap.shard_lo(s), rmap.shard_hi(s)
        sl = slice(a.row_ptr[lo], a.row_ptr[hi])
        return all_rows[sl] - lo, all_cols[sl], all_vals[sl]

    return _distribute_square(shard_coo, rmap, fmt, dtype or a.vals.dtype,
                              block_size, debug_a=a if debug else None)


def distribute_blocks(blocks, rmap: Map | None = None, fmt: str = "auto",
                      dtype=None, block_size: int = 1) -> DistMatrix:
    """``distribute()`` from already row-partitioned blocks — ``blocks[s]``
    is a CsrHost of rank s's owned rows with global column indices. No
    global matrix is assembled (the distributed AMG set-up's entry)."""
    rmap = rmap or Map.contiguous([b.shape[0] for b in blocks])
    assert rmap.n_shards == len(blocks)
    assert rmap.n_global == sum(b.shape[0] for b in blocks)

    def shard_coo(s):
        blk = blocks[s]
        return blk._rows(), blk.cols.astype(np.int64), blk.vals

    dtype = dtype or blocks[0].vals.dtype
    return _distribute_square(shard_coo, rmap, fmt, dtype, block_size)


def _ghost_slots(bc_cols, rmap: Map):
    """(ghost gids in makeColMap order, slot of each boundary entry): the
    native one-sort routine, or the numpy chain without the library."""
    from ..native import ghost_slots_native

    nat = ghost_slots_native(bc_cols)
    if nat is not None:
        _ghost_slots.native_calls += 1
        return nat
    _ghost_slots.numpy_calls += 1
    ghost_gids = np.unique(bc_cols)
    owners = rmap.owner_of(ghost_gids)
    order = np.lexsort((ghost_gids, owners))
    ghost_gids = ghost_gids[order]
    sort_perm = np.argsort(ghost_gids, kind="stable")
    lookup = np.searchsorted(ghost_gids[sort_perm], bc_cols)
    return ghost_gids, sort_perm[lookup]


_ghost_slots.native_calls = _ghost_slots.numpy_calls = 0


def _distribute_square(shard_coo, rmap: Map, fmt: str, dtype,
                       block_size: int, debug_a: CsrHost | None = None
                       ) -> DistMatrix:
    """Shared fillComplete body: per-rank COO → interior/boundary split,
    ghost ordering, frozen halo plans, format packing. ``shard_coo(s)``
    yields (local row, global col, value) for rank s's rows."""
    n_shards = rmap.n_shards
    npl = rmap.n_local_pad
    hdt = _host_dtype(dtype)

    ghosts_of, interior_csr, boundary_coo = [], [], []
    for s in range(n_shards):
        lo, hi = rmap.shard_lo(s), rmap.shard_hi(s)
        rs_g, cs_g, vs_g = shard_coo(s)
        owned = (cs_g >= lo) & (cs_g < hi)
        interior_csr.append(CsrHost.from_coo(
            rs_g[owned], cs_g[owned] - lo, vs_g[owned],
            (hi - lo, hi - lo), sum_duplicates=False))
        # makeColMap ordering: remotes grouped by owner, sorted by gid;
        # contiguous maps make owner-major order gid order
        ghost_gids, bc_slots = _ghost_slots(cs_g[~owned], rmap)
        ghosts_of.append(ghost_gids)
        boundary_coo.append((rs_g[~owned], bc_slots, vs_g[~owned]))

    plans, sends = build_halo_plans(ghosts_of, rmap, n_shards)

    stats = [_boundary_stats(t) for t in boundary_coo]
    kb = max(max((c for _, c in stats), default=0), 1)
    nb_pad = round_up(max((r for r, _ in stats), default=0) or 1,
                      ROW_ALIGN)
    # one interior format for every rank
    if fmt == "auto":
        probe = interior_csr[0]
        ndiag = len(np.unique(probe.cols.astype(np.int64) - probe._rows()))
        fmt = "dia" if ndiag <= 32 else "ell"
    if fmt == "dia":
        off_union = sorted({o for ic in interior_csr
                            for o in _diag_offsets(ic)})
    elif fmt == "bsr":
        b = block_size
        if b < 2:
            raise ValueError("fmt='bsr' needs block_size >= 2")
        for s in range(n_shards):
            if (rmap.shard_hi(s) - rmap.shard_lo(s)) % b:
                raise ValueError(
                    f"shard {s} size not divisible by block_size={b}")
        if npl % b:
            raise ValueError(f"local padding {npl} not divisible by {b}")
        kb_union = max(_bsr_width(ic, b) for ic in interior_csr)
    elif fmt == "ell":
        k_union = max(max(ic.max_row_length() for ic in interior_csr), 1)
    else:
        raise ValueError(f"unknown interior format {fmt!r}")

    interiors, boundaries = [], []
    for s in range(n_shards):
        if fmt == "dia":
            interiors.append(_csr_to_dia_fixed(interior_csr[s], off_union,
                                               npl, dtype))
        elif fmt == "bsr":
            interiors.append(_csr_to_bsr_fixed(interior_csr[s], b, dtype,
                                               npl // b, kb_union))
        else:
            e = csr_to_ell(interior_csr[s], dtype=dtype, k=k_union,
                           n_rows_pad=npl, device="cpu")
            interiors.append(EllMatrix(cols=e.cols, vals=e.vals, n_rows=npl,
                                       n_cols=npl, nnz=0))
        boundaries.append(_pack_boundary(boundary_coo[s], nb_pad, kb,
                                         npl, hdt))

    dm = DistMatrix(interior=interiors, boundary=_stack(boundaries),
                    plan=_stack(plans), row_map=rmap)
    if debug_a is not None:
        _debug_validate(dm, ghosts_of, sends)
    return dm


def _debug_validate(dm: DistMatrix, ghosts_of, sends) -> None:
    """Invariant checks at fillComplete (the reference's debug-mode
    cross-process consistency checks): plan reciprocity, receive-buffer
    indexing and boundary column ranges."""
    rmap = dm.row_map
    p = rmap.n_shards
    seg = dm.plan.seg
    g_pad = dm.plan.n_ghost_pad
    for s in range(p):
        g = ghosts_of[s]
        owners = rmap.owner_of(g)
        for gid, o in zip(g, owners):
            lid = gid - rmap.shard_lo(int(o))
            assert lid in set(sends[int(o)][s].tolist()), \
                f"ghost gid {gid} of shard {s} missing from owner {o}'s send"
        flat_len = (p if dm.plan.mode == "a2a"
                    else len(dm.plan.offsets)) * seg
        sel = dm.plan.recv_sel[s]
        assert (sel[: len(g)] < flat_len).all(), "recv_sel out of range"
        bc = dm.boundary.cols[s]
        assert (bc < rmap.n_local_pad + g_pad).all(), \
            "boundary column index beyond ghost space"


def _diag_offsets(c: CsrHost):
    return {int(o) for o in np.unique(c.cols.astype(np.int64) - c._rows())}


def _csr_to_dia_fixed(c: CsrHost, offsets, n_rows_pad, dtype) -> DiaMatrix:
    """DIA on the CPU with a prescribed offset set (the union over
    ranks)."""
    d = csr_to_dia(c, dtype=dtype, n_rows_pad=n_rows_pad, device="cpu")
    data = torch.zeros((len(offsets), n_rows_pad), dtype=d.dtype)
    for i, o in enumerate(offsets):
        if o in d.offsets:
            data[i] = d.data[d.offsets.index(o)]
    return DiaMatrix(data=data, offsets=tuple(offsets), n_rows=n_rows_pad,
                     n_cols=n_rows_pad, nnz=0)


def _bsr_width(c: CsrHost, b: int) -> int:
    """Natural blocks-per-row width of ``c`` in b×b blocks."""
    if c.shape[0] % b:
        c = pad_csr_square(c, b)
    nb = c.shape[1] // b
    key = np.unique(c._rows() // b * nb + c.cols.astype(np.int64) // b)
    return max(int(np.bincount(key // nb).max(initial=0)), 1)


def _csr_to_bsr_fixed(c: CsrHost, b: int, dtype, n_brows_pad: int,
                      kb: int) -> BsrMatrix:
    """Block-ELL on the CPU with a prescribed block-row count and width
    (the union over ranks); pad block rows are zero blocks."""
    m, n = c.shape
    mb, nb = m // b, n // b
    rows_rep = c._rows()
    brow = rows_rep // b
    bcol = c.cols.astype(np.int64) // b
    uniq_key, inv = np.unique(brow * nb + bcol, return_inverse=True)
    ub_row, ub_col = uniq_key // nb, uniq_key % nb
    blens = np.bincount(ub_row, minlength=mb)
    bcols = np.zeros((n_brows_pad, kb), dtype=np.int64)
    bvals = np.zeros((n_brows_pad, kb, b, b), dtype=_host_dtype(dtype))
    bptr = np.zeros(mb + 1, dtype=np.int64)
    np.cumsum(blens, out=bptr[1:])
    slot = np.arange(len(uniq_key)) - bptr[ub_row]
    bcols[ub_row, slot] = ub_col
    bvals[brow, slot[inv.reshape(-1)], rows_rep % b, c.cols % b] = c.vals
    bcols[mb:, 0] = nb - 1  # the reference's min(ib, nb − 1), ib ≥ nb
    return BsrMatrix(bcols=torch.from_numpy(bcols),
                     bvals=_tensor(bvals, "cpu", dtype), block_size=b,
                     n_rows=n_brows_pad * b, n_cols=n_brows_pad * b, nnz=0)


# ---------------------------------------------------------------------------
# runtime (per rank)
# ---------------------------------------------------------------------------


class _Pending:
    """A posted exchange: the works to wait on, the buffers they use (in
    lane order) and the vector it serves. ``wait()`` returns the flat
    receive buffer (n_lanes·seg, k) on the vector's device."""

    def __init__(self, works, sent, recv, comm, like):
        self.works, self.sent, self.recv = works, sent, recv
        self.comm, self.like = comm, like

    def wait(self) -> torch.Tensor:
        for w in self.works:
            w.wait()
        k = self.like.shape[1]
        flat = torch.cat([b.reshape(-1, k) for b in self.recv]) \
            if self.recv else self.like.new_zeros((0, k))
        self.sent = None
        return (self.comm.unwire(flat, self.like)
                if isinstance(self.comm, ProcessComm) else flat)


def _serial(comm: Comm) -> bool:
    """True for a comm without a process group, which must be one rank:
    its exchanges are local copies."""
    if isinstance(comm, ProcessComm):
        return False
    if comm.size != 1:
        raise ValueError("a halo exchange over several ranks needs a "
                         "ProcessComm")
    return True


def _post_a2a(comm: Comm, sbuf: torch.Tensor, like) -> _Pending:
    """All-to-all of ``sbuf`` (P, seg, k): lane t goes to rank t, lane t of
    the result came from rank t."""
    if _serial(comm):
        return _Pending([], None, [sbuf.clone()], comm, like)
    wired = comm.wire(sbuf)
    rbuf = torch.empty_like(wired)
    work = dist.all_to_all_single(rbuf, wired, group=comm.group,
                                  async_op=True)
    return _Pending([work], wired, [rbuf], comm, like)


def _post_p2p(comm: Comm, lanes, dests, srcs, like) -> _Pending:
    """Send ``lanes[i]`` (seg, k) to rank ``dests[i]`` and receive lane i
    from rank ``srcs[i]``: one batch of point-to-point sends and
    receives."""
    if _serial(comm):
        return _Pending([], None, [ln.clone() for ln in lanes], comm, like)
    wired = [comm.wire(ln) for ln in lanes]
    recv = [torch.empty_like(w) for w in wired]
    ops = []
    for i, (w, r) in enumerate(zip(wired, recv)):
        ops.append(dist.P2POp(dist.isend, w, dests[i], comm.group, tag=i))
        ops.append(dist.P2POp(dist.irecv, r, srcs[i], comm.group, tag=i))
    works = dist.batch_isend_irecv(ops) if ops else []
    return _Pending(works, wired, recv, comm, like)


def post_exchange(x: torch.Tensor, plan: HaloPlan, comm: Comm) -> _Pending:
    """Post the ghost gather of ``x`` (the doPosts half); ``.wait()`` on the
    result gives the flat receive buffer for :func:`finish_exchange`."""
    x2 = x[:, None] if x.ndim == 1 else x
    p, me = comm.size, comm.index()
    if plan.mode == "a2a":
        return _post_a2a(comm, x2[plan.send_idx], x2)  # (P, seg, k)
    dests = [(me + off) % p for off in plan.offsets]
    srcs = [(me - off) % p for off in plan.offsets]
    return _post_p2p(comm, [x2[plan.send_idx[t]] for t in dests], dests,
                     srcs, x2)


def finish_exchange(pending: _Pending, plan: HaloPlan,
                    was_1d: bool) -> torch.Tensor:
    """The doWaits half: ghosts (g_pad,) or (g_pad, k) from a posted
    exchange."""
    ghosts = pending.wait()[plan.recv_sel]
    return ghosts[:, 0] if was_1d else ghosts


def exchange(x: torch.Tensor, plan: HaloPlan, comm: Comm) -> torch.Tensor:
    """Ghost gather: returns (g_pad,) or (g_pad, k) ghost values."""
    return finish_exchange(post_exchange(x, plan, comm), plan, x.ndim == 1)


def exchange_reverse(ghosts: torch.Tensor, plan: HaloPlan, comm: Comm):
    """Reverse (Export-direction) transfer: each rank's per-ghost
    contributions travel back to the ghost's owner (Export's reversal of
    an Import plan). Returns (contrib, idx, valid): the received
    contributions, the local row each lands on (send_idx order) and a
    validity mask."""
    was_1d = ghosts.ndim == 1
    g2 = ghosts[:, None] if was_1d else ghosts
    k = g2.shape[1]
    g2 = torch.where(plan.ghost_valid[:, None], g2, torch.zeros_like(g2))
    p, me = comm.size, comm.index()
    n_lanes = p if plan.mode == "a2a" else len(plan.offsets)
    flat = g2.new_zeros((n_lanes * plan.seg, k))
    # pad ghost slots point at position 0 but carry zeros: the add is exact
    flat.index_add_(0, plan.recv_sel, g2)
    lanes = flat.reshape(n_lanes, plan.seg, k)
    if plan.mode == "a2a":
        contrib = _post_a2a(comm, lanes, g2).wait()
        idx = plan.send_idx.reshape(-1)
        valid = plan.send_valid.reshape(-1)
    else:
        dests = [(me - off) % p for off in plan.offsets]
        srcs = [(me + off) % p for off in plan.offsets]
        contrib = _post_p2p(comm, list(lanes), dests, srcs, g2).wait()
        idx = torch.cat([plan.send_idx[t] for t in srcs])
        valid = torch.cat([plan.send_valid[t] for t in srcs])
    if was_1d:
        contrib = contrib[:, 0]
    return contrib, idx, valid


def export_combine(x: torch.Tensor, ghosts: torch.Tensor, plan: HaloPlan,
                   comm: Comm, mode: str = "ADD") -> torch.Tensor:
    """doExport: combine each rank's ghost contributions into the owned
    vector under a CombineMode.

    ADD     sum contributions into existing values
    INSERT / REPLACE   overwrite with the incoming value (with several
            contributors the order is unspecified, as in the reference)
    ABSMAX  replace with max(|old|, |incoming|)
    ZERO    no communication: x is returned unchanged (the restricted
            Schwarz combine)
    """
    mode = mode.upper()
    if mode == "ZERO":
        return x
    if mode not in ("ADD", "INSERT", "REPLACE", "ABSMAX"):
        raise ValueError(f"unknown CombineMode {mode!r}")
    contrib, idx, valid = exchange_reverse(ghosts, plan, comm)
    was_1d = x.ndim == 1
    x2 = x[:, None] if was_1d else x
    c2 = (contrib[:, None] if was_1d else contrib).to(x2.dtype)
    if mode == "ADD":
        y = x2.index_add(0, idx, torch.where(valid[:, None], c2,
                                             torch.zeros_like(c2)))
    elif mode in ("INSERT", "REPLACE"):
        y = x2.clone()
        y[idx[valid]] = c2[valid]
    else:
        sel, cv = idx[valid], c2[valid].abs()
        m = torch.zeros_like(x2).scatter_reduce_(
            0, sel[:, None].expand_as(cv), cv, "amax")
        touched = torch.zeros(x2.shape[0], dtype=torch.bool,
                              device=x2.device)
        touched[sel] = True
        y = torch.where(touched[:, None], torch.maximum(x2.abs(), m), x2)
    return y[:, 0] if was_1d else y


def apply_local_transpose(mat_interior, mat_boundary: BoundaryPart,
                          plan: HaloPlan, x: torch.Tensor,
                          comm: Comm) -> torch.Tensor:
    """Distributed transpose SpMV y = Aᵀx, per rank (the reference's
    ``apply(..., TRANS)``): the local rows scatter Aᵀ contributions into
    the extended [owned | ghost] column space; ghost contributions ride
    the existing Import plan in reverse (``export_combine`` ADD). Square
    row-distributed matrices only."""
    was_1d = x.ndim == 1
    x2 = x[:, None] if was_1d else x
    n_loc, k = x2.shape
    y = spmv(mat_interior, x, transpose=True)  # interior cols are owned
    y2 = y[:, None] if was_1d else y
    # boundary rows: y_ext[cols[r, j]] += vals[r, j] * x[rows_idx[r]]
    xb = x2[mat_boundary.rows_idx]
    contrib = mat_boundary.vals[:, :, None] * xb[:, None, :].to(
        mat_boundary.vals.dtype)
    ext = contrib.new_zeros((n_loc + plan.n_ghost_pad, k))
    ext.index_add_(0, mat_boundary.cols.reshape(-1), contrib.reshape(-1, k))
    y2 = y2 + ext[:n_loc].to(y2.dtype)
    y2 = export_combine(y2, ext[n_loc:].to(y2.dtype), plan, comm, "ADD")
    return y2[:, 0] if was_1d else y2


def apply_local(mat_interior, mat_boundary: BoundaryPart, plan: HaloPlan,
                x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """Distributed SpMV, per rank: post the exchange, run the interior SpMV
    while it travels, then wait and add the boundary rows."""
    pending = post_exchange(x, plan, comm)
    y = spmv(mat_interior, x)  # independent of the exchange
    was_1d = x.ndim == 1
    ghosts = finish_exchange(pending, plan, was_1d)
    x2 = x[:, None] if was_1d else x
    g2 = ghosts[:, None] if was_1d else ghosts
    ext = torch.cat([x2, g2.to(x2.dtype)])
    gathered = ext[mat_boundary.cols]  # (nb, kb, k)
    contrib = torch.einsum("rk,rkn->rn", mat_boundary.vals,
                           gathered.to(mat_boundary.vals.dtype))
    y2 = y[:, None] if was_1d else y
    y2 = y2.index_add(0, mat_boundary.rows_idx, contrib.to(y2.dtype))
    return y2[:, 0] if was_1d else y2


def gather_extended(ds_sel, ds_valid, plan: HaloPlan, x: torch.Tensor,
                    comm: Comm) -> torch.Tensor:
    """Per rank: exchange ghosts and assemble the extended-slab vector —
    owned rows and halo planes in extended-row order, off-grid rows zero.
    Shared by the DistStencil apply and the fused Chebyshev smoother."""
    ghosts = exchange(x, plan, comm)
    was_1d = x.ndim == 1
    x2 = x[:, None] if was_1d else x
    g2 = ghosts[:, None] if was_1d else ghosts
    allv = torch.cat([x2, g2.to(x2.dtype)])
    ext = torch.where(ds_valid[:, None], allv[ds_sel], torch.zeros((),
                      dtype=x2.dtype, device=x2.device))
    return ext[:, 0] if was_1d else ext


def apply_local_stencil(ds_sel, ds_valid, op_loc, depth, plan: HaloPlan,
                        x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """Per-rank DistStencil apply: the extended slab through the stencil
    kernel (``spmv``), the owned planes kept."""
    nx, ny, _ = op_loc.dims
    pxy = nx * ny
    npl = x.shape[0]
    ext = gather_extended(ds_sel, ds_valid, plan, x, comm)
    y = spmv(op_loc, ext)
    return y[depth * pxy: depth * pxy + npl]


# ---------------------------------------------------------------------------
# values-only refill (graph and plan reuse)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RefillPlan:
    """Frozen values-only refill recipe — the graph-reuse contract of
    ``Tpetra::CrsMatrix::resumeFill``/``fillComplete``: when a matrix's
    values change but its sparsity does not, the halo plan, boundary
    structure and index arrays are reused; only the value arrays are
    regenerated by one gather each.

    ``leaf_idx`` holds, for every value array of (interiors, boundary) in
    :func:`_value_arrays` order, an int64 array with entries >= 0 (gather
    from the CSR nnz array), -1 (structural zero or padding) or -2
    (identity-padding one)."""

    leaf_idx: tuple
    nnz: int


def _infer_fmt(dm: DistMatrix):
    it = dm.interior[0]
    if isinstance(it, DiaMatrix):
        return "dia", 1
    if isinstance(it, BsrMatrix):
        return "bsr", it.block_size
    return "ell", 1


def _value_arrays(dm: DistMatrix):
    """The value arrays of a host DistMatrix as numpy, in a fixed order:
    each rank's interior values, then the stacked boundary values."""
    out = []
    for m in dm.interior:
        t = m.data if isinstance(m, DiaMatrix) else (
            m.bvals if isinstance(m, BsrMatrix) else m.vals)
        out.append(t.double().numpy())
    out.append(np.asarray(dm.boundary.vals, np.float64))
    return out


def build_refill(a: CsrHost, dm: DistMatrix) -> RefillPlan:
    """Capture the value-position mapping of ``dm`` relative to ``a``'s nnz
    order. One symbolic distribute of a position-marker matrix; every
    later :func:`refill_values` is a pure gather."""
    nnz = len(a.vals)
    marker = CsrHost(a.row_ptr, a.cols,
                     np.arange(2, nnz + 2, dtype=np.float64), a.shape)
    fmt, bs = _infer_fmt(dm)
    if dm.col_map is not None:
        raise NotImplementedError(
            "build_refill supports square DistMatrix (rect transfers are "
            "rebuilt by the AMG setup that owns them)")
    dm_idx = distribute(marker, dm.row_map.n_shards, fmt=fmt,
                        dtype=np.float64, rmap=dm.row_map, block_size=bs)
    idx = []
    for v in _value_arrays(dm_idx):
        out = np.full(v.shape, -1, dtype=np.int64)
        out[v == 1.0] = -2
        sel = v >= 2.0
        out[sel] = np.round(v[sel]).astype(np.int64) - 2
        idx.append(out)
    return RefillPlan(leaf_idx=tuple(idx), nnz=nnz)


def refill_values(dm: DistMatrix, plan: RefillPlan,
                  new_vals: np.ndarray) -> DistMatrix:
    """A new DistMatrix with ``new_vals`` (the nnz array of a matrix with
    unchanged sparsity) scattered into ``dm``'s frozen layout. No plan
    build, no ghost analysis."""
    if len(new_vals) != plan.nnz:
        raise ValueError(
            f"value count {len(new_vals)} != pattern nnz {plan.nnz}")
    new_vals = np.asarray(new_vals, dtype=np.float64)

    def gather(ix):
        return np.where(ix >= 0, new_vals[np.maximum(ix, 0)],
                        np.where(ix == -2, 1.0, 0.0))

    interiors = []
    for m, ix in zip(dm.interior, plan.leaf_idx[:-1]):
        vals = torch.from_numpy(gather(ix)).to(m.dtype)
        key = "data" if isinstance(m, DiaMatrix) else (
            "bvals" if isinstance(m, BsrMatrix) else "vals")
        interiors.append(dataclasses.replace(m, **{key: vals}))
    bvals = gather(plan.leaf_idx[-1]).astype(dm.boundary.vals.dtype)
    return DistMatrix(interior=interiors,
                      boundary=dataclasses.replace(dm.boundary, vals=bvals),
                      plan=dm.plan, row_map=dm.row_map, col_map=dm.col_map)
