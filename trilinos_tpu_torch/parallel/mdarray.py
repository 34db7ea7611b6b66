"""Structured multi-dimensional distributed arrays (the Domi analogue).

Counterpart of ``trilinos_tpu/parallel/mdarray.py`` (Domi's MDComm,
MDMap and MDVector: a d-dimensional process grid, global extents split
per axis, communication padding and periodic flags, ``updateCommPad()``).

An :class:`MDMap` is a declarative layout: the global shape, the axis of
a :class:`~.comm.ProcessGrid` each array axis is split over (``None``: a
local axis), halo widths and periodic flags. The grid is the MDComm. Every
function here runs inside a rank on that rank's block (a C-order tensor):

* :func:`halo_pad` is ``updateCommPad``: it grows the block by its ghost
  slabs, one exchange per split axis, axis by axis, so that a later axis
  moves slabs that are already padded and the corner ghosts come right.
  A non-periodic global edge receives zeros (the JAX package's
  ``ppermute`` fills a rank without a source with zeros); an axis that is
  local or split over a grid axis of size 1 pads itself, by wrap or by
  zeros, and sends nothing;
* :func:`md_map_apply`, :func:`md_solve` (any solver of
  ``trilinos_tpu_torch.solvers``, reductions over the grid) and
  :func:`md_dot`;
* :func:`md_poly_local` / :func:`md_poly_apply`: the communication-avoiding
  three-term recurrence, one exchange of depth s·reach feeding all s
  stages on pads that shrink stage by stage;
* :func:`stencil_block_fn`: a constant stencil's valid-region apply on a
  padded block through the port's ``stencil_spmv`` (``stencil_kernel`` on
  the card).

The exchange goes through the axis's ``ProcessComm`` (``wire``/``unwire``),
so under gloo a CUDA block is staged through the host and counted in
``staged_bytes``. Each ghost slab travels with the tag of its direction,
so the two messages to the one neighbour of a periodic axis of size 2
stay apart.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from .comm import ProcessGrid

# a slab sent to the rank above becomes its low ghosts, one sent below
# its high ghosts
_UP, _DOWN = 0, 1


@dataclasses.dataclass(frozen=True)
class MDMap:
    """Layout of a structured distributed array.

    global_shape: global extents per axis.
    grid_axes:    the grid axis name each array axis is split over, or
                  None for a local axis.
    halo:         ghost width per axis (``halo_pad``).
    periodic:     per-axis periodic wrap-around of the ghost exchange.
    """

    global_shape: tuple
    grid_axes: tuple
    halo: tuple = ()
    periodic: tuple = ()

    def __post_init__(self):
        nd = len(self.global_shape)
        if len(self.grid_axes) != nd:
            raise ValueError("grid_axes length != ndim")
        object.__setattr__(self, "global_shape",
                           tuple(int(d) for d in self.global_shape))
        object.__setattr__(self, "halo", tuple(self.halo) or (0,) * nd)
        object.__setattr__(self, "periodic",
                           tuple(self.periodic) or (False,) * nd)
        if len(self.halo) != nd or len(self.periodic) != nd:
            raise ValueError("halo/periodic length != ndim")

    def local_shape(self, grid: ProcessGrid) -> tuple:
        out = []
        for dim, ax in zip(self.global_shape, self.grid_axes):
            if ax is None:
                out.append(dim)
                continue
            n = grid.axis_size(ax)
            if dim % n:
                raise ValueError(f"global extent {dim} not divisible by grid "
                                 f"axis {ax!r} size {n}")
            out.append(dim // n)
        return tuple(out)

    def _slices(self, grid: ProcessGrid, coords) -> tuple:
        loc = self.local_shape(grid)
        return tuple(
            slice(0, d) if ax is None else
            slice(coords[grid.axis_names.index(ax)] * d,
                  (coords[grid.axis_names.index(ax)] + 1) * d)
            for d, ax in zip(loc, self.grid_axes))

    def local_block(self, arr, grid: ProcessGrid, device=None,
                    dtype=None) -> torch.Tensor:
        """This rank's block of the global array ``arr`` (the MDVector
        constructor, the twin of ``distribute``): a contiguous tensor on
        ``device`` (``None``: a tensor's own device, else the card)."""
        if tuple(arr.shape) != self.global_shape:
            raise ValueError(f"array shape {tuple(arr.shape)} != "
                             f"global_shape {self.global_shape}")
        blk = arr[self._slices(grid, grid.coords)]
        if isinstance(blk, np.ndarray):
            # a copy: the block must not alias the caller's array
            blk = torch.from_numpy(np.array(blk))
            dev = resolve_device(device)
        else:
            blk = blk.clone()
            dev = blk.device if device is None else resolve_device(device)
        return blk.to(dev, dtype).contiguous()

    def gather(self, block: torch.Tensor, grid: ProcessGrid) -> torch.Tensor:
        """The global array from every rank's block (one all_gather over
        the grid), on every rank."""
        loc = self.local_shape(grid)
        if tuple(block.shape) != loc:
            raise ValueError(f"block shape {tuple(block.shape)} != local "
                             f"shape {loc}")
        parts = grid.all_gather(block.reshape(1, -1))
        out = block.new_empty(self.global_shape)
        for r in range(grid.size):
            out[self._slices(grid, grid.coords_of(r))] = parts[r].reshape(loc)
        return out


def _exchange(comm, lo_slab, hi_slab, periodic: bool):
    """(low ghosts, high ghosts) along one split axis: this rank's high
    slab goes up and its low slab down; what comes from below is the low
    ghosts, from above the high ghosts, zeros past a non-periodic edge."""
    c, n = comm.rank, comm.size
    below = (c - 1) % n if periodic or c > 0 else None
    above = (c + 1) % n if periodic or c < n - 1 else None
    ops, got = [], {}
    for peer, slab, recv_tag, send_tag in ((below, lo_slab, _UP, _DOWN),
                                           (above, hi_slab, _DOWN, _UP)):
        if peer is None:
            continue
        wired = comm.wire(slab)
        got[recv_tag] = torch.empty_like(wired)
        ops.append(dist.P2POp(dist.isend, wired, comm.peer(peer), comm.group,
                              tag=send_tag))
        ops.append(dist.P2POp(dist.irecv, got[recv_tag], comm.peer(peer),
                              comm.group, tag=recv_tag))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    lo = (comm.unwire(got[_UP], lo_slab) if _UP in got
          else torch.zeros_like(lo_slab))
    hi = (comm.unwire(got[_DOWN], hi_slab) if _DOWN in got
          else torch.zeros_like(hi_slab))
    return lo, hi


def _pad_axis(u, axis, w, grid_axis, periodic, grid):
    """Grow ``u`` by ``w`` ghost cells at both ends of ``axis``: one
    exchange with the neighbours along a split axis, a local wrap or zero
    pad along an axis that is local or split over a grid axis of size 1."""
    if w == 0:
        return u
    if w > u.shape[axis]:
        raise ValueError(f"axis {axis}: halo {w} > local extent "
                         f"{u.shape[axis]}")
    lo_slab = u.narrow(axis, 0, w)
    hi_slab = u.narrow(axis, u.shape[axis] - w, w)
    if grid_axis is None or grid.axis_size(grid_axis) == 1:
        if periodic:
            lo, hi = hi_slab, lo_slab
        else:
            lo, hi = torch.zeros_like(lo_slab), torch.zeros_like(hi_slab)
    else:
        lo, hi = _exchange(grid.axis(grid_axis), lo_slab.contiguous(),
                           hi_slab.contiguous(), periodic)
    return torch.cat([lo, u, hi], dim=axis)


def halo_pad(u: torch.Tensor, mdmap: MDMap, grid: ProcessGrid):
    """updateCommPad(): this rank's block padded with ghost slabs on every
    axis with a halo, axis by axis (later axes exchange slabs already
    padded, so the corner ghosts are right)."""
    for axis in range(u.ndim):
        u = _pad_axis(u, axis, mdmap.halo[axis], mdmap.grid_axes[axis],
                      mdmap.periodic[axis], grid)
    return u


def md_map_apply(mdmap: MDMap, grid: ProcessGrid, local_fn):
    """The rank's apply: block → ``local_fn(halo_pad(block))``, where
    ``local_fn`` shrinks the pad back (a stencil's valid-region apply). The
    Domi MDVector compute idiom."""
    return lambda u: local_fn(halo_pad(u, mdmap, grid))


def md_solve(solver, mdmap: MDMap, grid: ProcessGrid, local_fn,
             b_block: torch.Tensor, prec_local=None, **solver_kw):
    """Run any Krylov solver of ``trilinos_tpu_torch.solvers`` on a field
    split over the grid: the operator is ``local_fn(halo_padded_block)``,
    every reduction runs over the whole grid. ``prec_local`` preconditions
    with a block → block function (such as :func:`md_poly_local`, the CA
    fused Chebyshev smoother). Returns the solver's SolveResult with ``x``
    as this rank's block."""
    shape = tuple(b_block.shape)
    if shape != mdmap.local_shape(grid):
        raise ValueError(f"b block shape {shape} != local shape "
                         f"{mdmap.local_shape(grid)}")

    def op(v):
        return local_fn(halo_pad(v.reshape(shape), mdmap, grid)).reshape(-1)

    kw = dict(solver_kw)
    if prec_local is not None:
        if "prec" in kw:
            raise ValueError("pass either prec_local (block form) or prec "
                             "(flat form), not both")
        kw["prec"] = lambda v: prec_local(v.reshape(shape)).reshape(-1)
    res = solver(op, b_block.reshape(-1), comm=grid, **kw)
    return dataclasses.replace(res, x=res.x.reshape(shape))


def _center_crop(u, widths):
    return u[tuple(slice(w, d - w) for w, d in zip(widths, u.shape))]


def md_poly_local(mdmap: MDMap, grid: ProcessGrid, stage_apply, stages,
                  reach: int = 1):
    """Communication-avoiding polynomial sweep on this rank's block: ONE
    halo exchange of depth s·reach feeds the three-term recurrence

        u_0 = x;  u_j = a_j·(A u_{j-1}) + b_j·u_{j-1} + g_j·u_{j-2} + z_j·x

    on pads that shrink by ``reach`` a stage (the N-D grid's twin of
    ``driver.dist_cheb_fused``). ``stage_apply`` maps a padded block to
    one shrunk by ``reach`` cells a side; ``mdmap.halo`` must be
    len(stages)·reach on every axis with a halo. A ones mask, from the
    rank's grid coordinates alone (no communication), zeroes every cell
    beyond a non-periodic global edge after each stage, so those ghosts
    act as the truncated operator while interior cuts hold real
    neighbour data. Returns the block → block function."""
    s = len(stages)
    for ax, h in enumerate(mdmap.halo):
        if h and h != s * reach:
            raise ValueError(f"axis {ax}: halo {h} != len(stages)*reach "
                             f"{s * reach}")
    local_shape = mdmap.local_shape(grid)
    crop = tuple(reach if h else 0 for h in mdmap.halo)

    def in_domain_mask(like):
        """Ones on the padded block's in-domain cells, zeros on ghosts past
        a non-periodic global edge; None when nothing is masked."""
        m = None
        for ax, (h, per) in enumerate(zip(mdmap.halo, mdmap.periodic)):
            if h == 0 or per:
                continue
            name = mdmap.grid_axes[ax]
            first = 0 if name is None else grid.coord(name) * local_shape[ax]
            gpos = first + torch.arange(local_shape[ax] + 2 * h,
                                        device=like.device) - h
            ok = (gpos >= 0) & (gpos < mdmap.global_shape[ax])
            shape = [1] * len(local_shape)
            shape[ax] = -1
            ok = ok.reshape(shape)
            m = ok if m is None else m & ok
        return None if m is None else m.expand(like.shape).to(like.dtype)

    def shrink(u, j):
        return _center_crop(u, tuple(j * c for c in crop))

    def run(x):
        ext = halo_pad(x, mdmap, grid)
        mask = in_domain_mask(ext)
        u_prev2, u_prev = torch.zeros_like(ext), ext
        for j, (a, b, g, z) in enumerate(stages, start=1):
            u = torch.zeros_like(shrink(ext, j))
            if a:
                u = a * stage_apply(u_prev)
            if b:
                u = u + b * shrink(u_prev, 1)
            if g:
                u = u + g * shrink(u_prev2, 2 if j > 1 else 1)
            if z:
                u = u + z * shrink(ext, j)
            if mask is not None:  # fully periodic: nothing to mask
                u = u * shrink(mask, j)
            # each u_k keeps its natural pad (s - k)·reach: the g-term two
            # stages later crops by exactly 2
            u_prev2, u_prev = u_prev, u
        return u_prev

    return run


def md_poly_apply(mdmap: MDMap, grid: ProcessGrid, stage_apply, stages,
                  reach: int = 1):
    """The JAX package's global ``md_poly_apply``: in a rank it is the
    block function :func:`md_poly_local`."""
    return md_poly_local(mdmap, grid, stage_apply, stages, reach)


def md_dot(grid: ProcessGrid):
    """Global dot of two fields' blocks: local sum, one psum over the
    grid."""
    return lambda a, b: grid.psum(torch.sum(a * b))


def stencil_block_fn(stencil):
    """A constant stencil's valid-region apply on a padded block: block
    (d0, …) → the stencil on it, shrunk by the stencil's reach at every
    side, through ``stencil_spmv`` (``stencil_kernel`` on the card, its
    plain version on the CPU). ``stencil`` is [((dx, dy, dz), c), …] with x
    the block's last axis: a C-order block runs fastest along its last
    axis and ``StencilOp`` along x, so the block's dims go to it reversed.
    The flat block is padded with zeros to the operator's ``n_rows_pad``
    (the pad rows are identity rows and are dropped)."""
    from ..ops.stencil_op import StencilOp, stencil_spmv

    stencil = tuple((tuple(o), float(c)) for o, c in stencil)
    reach = max(max(abs(d) for d in o) for o, _ in stencil)
    ops = {}

    def apply(u):
        key = (tuple(u.shape), u.dtype)
        if key not in ops:
            ops[key] = StencilOp.create(
                tuple(reversed(u.shape)), stencil,
                dtype=str(u.dtype).removeprefix("torch."))
        op = ops[key]
        flat = torch.zeros(op.n_rows_pad, dtype=u.dtype, device=u.device)
        flat[:op.n_rows] = u.reshape(-1)
        y = stencil_spmv(op, flat)[:op.n_rows].reshape(u.shape)
        return _center_crop(y, (reach,) * u.ndim)

    return apply
