"""Communicator abstraction.

Counterpart of ``trilinos_tpu/parallel/comm.py``: the reduction surface the
solvers are written against (the analogue of ``Teuchos::Comm``).

* ``SerialComm``: one rank; reductions are the identity.
* ``ProcessComm``: one process per rank over a ``torch.distributed``
  process group, the role MPI plays for Tpetra and the twin of the JAX
  package's ``AxisComm`` (which runs P shards as one program under
  ``shard_map``). Reductions are ``all_reduce``, the tiled gather is
  ``all_gather``; the halo exchanges of ``distmatrix`` go through
  :meth:`ProcessComm.wire` and :meth:`ProcessComm.unwire` too.
* ``ProcessGrid``: the ranks of a ``ProcessComm`` laid out as a grid with
  named axes (the JAX package's ``Mesh`` of several axes), outer-major, with
  one ``ProcessComm`` per axis over the grid line through this rank. It is
  itself a ``ProcessComm`` over the whole group, so every driver that takes
  a comm takes a grid.

The transport is fixed when a ``ProcessComm`` is made and never changes
while it runs. ``nccl`` moves device buffers as they are and refuses a CPU
tensor. ``gloo`` moves CPU tensors as they are; a CUDA tensor is staged
through host memory on every collective (gloo's all-to-all and
point-to-point take CPU tensors only), and ``staged_bytes`` counts the
bytes that went through the host, both ways.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..ops.blas import local_dot


class Comm:
    """Reduction surface the solver layer is written against."""

    size: int

    def psum(self, x):
        raise NotImplementedError

    def pmax(self, x):
        raise NotImplementedError

    def pmin(self, x):
        raise NotImplementedError

    def index(self) -> int:
        """This rank's position in the group (0 on serial)."""
        raise NotImplementedError

    def pvary(self, x):
        """Identity: the JAX package marks shard-varying values for
        ``shard_map``; separate processes need no such mark."""
        return x


class SerialComm(Comm):
    size = 1

    def psum(self, x):
        return x

    def pmax(self, x):
        return x

    def pmin(self, x):
        return x

    def index(self) -> int:
        return 0

    def broadcast(self, x, src: int):
        return x

    def __repr__(self):
        return "SerialComm()"


class ProcessComm(Comm):
    """Collectives over a ``torch.distributed`` process group (the default
    group when ``group`` is None), which must be initialized. The backend,
    read from the group, fixes the transport (see the module docstring)."""

    def __init__(self, group=None):
        if not dist.is_initialized():
            raise RuntimeError("ProcessComm needs an initialized process "
                               "group (torch.distributed)")
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.backend = str(dist.get_backend(group))
        if self.backend not in ("gloo", "nccl"):
            raise ValueError(f"ProcessComm takes the gloo or nccl backend, "
                             f"got {self.backend}")
        self.staged_bytes = 0

    def index(self) -> int:
        return self.rank

    def peer(self, r: int) -> int:
        """The default group's rank of this group's rank ``r`` (what
        ``torch.distributed``'s point-to-point calls take)."""
        return r if self.group is None else dist.get_global_rank(self.group,
                                                                 r)

    # -- transport ----------------------------------------------------------
    def wire(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the transport takes it: the tensor itself, or (gloo, a
        CUDA tensor) a contiguous host copy, counted in ``staged_bytes``."""
        if self.backend == "nccl":
            if t.device.type != "cuda":
                raise ValueError(f"the nccl transport takes CUDA tensors, "
                                 f"got one on {t.device}")
            return t.contiguous()
        if t.device.type == "cuda":
            self.staged_bytes += t.numel() * t.element_size()
            return t.detach().to("cpu").contiguous()
        if t.device.type != "cpu":
            raise ValueError(f"the gloo transport takes CPU or CUDA "
                             f"tensors, got one on {t.device}")
        return t.contiguous()

    def unwire(self, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """A received buffer back on ``like``'s device (counted when it was
        staged)."""
        if t.device != like.device:
            self.staged_bytes += t.numel() * t.element_size()
            return t.to(like.device)
        return t

    def _reduce(self, x, op):
        buf = self.wire(torch.as_tensor(x)).clone()
        dist.all_reduce(buf, op=op, group=self.group)
        return self.unwire(buf, torch.as_tensor(x))

    def psum(self, x):
        return self._reduce(x, dist.ReduceOp.SUM)

    def pmax(self, x):
        return self._reduce(x, dist.ReduceOp.MAX)

    def pmin(self, x):
        return self._reduce(x, dist.ReduceOp.MIN)

    def broadcast(self, x, src: int) -> torch.Tensor:
        """Rank ``src``'s ``x`` on every rank. The other ranks' ``x`` gives
        only the shape, dtype and device of the result."""
        x = torch.as_tensor(x)
        if self.rank == src:
            buf = self.wire(x)
        elif self.backend == "gloo":
            buf = torch.empty(x.shape, dtype=x.dtype)
        else:
            buf = torch.empty_like(x)
        dist.broadcast(buf, src=self.peer(src), group=self.group)
        return x if self.rank == src else self.unwire(buf, x)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Tiled gather: every rank's ``x`` (equal shapes) concatenated
        along axis 0 in rank order."""
        buf = self.wire(x)
        parts = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather(parts, buf, group=self.group)
        return self.unwire(torch.cat(parts), x)

    def barrier(self) -> None:
        dist.barrier(group=self.group)

    def __repr__(self):
        return (f"ProcessComm(rank={self.rank}, size={self.size}, "
                f"backend={self.backend!r})")


class ProcessGrid(ProcessComm):
    """The ranks of ``comm`` as a grid of ``shape`` with named axes,
    outer-major: this rank's ``coords`` flatten (C order) to its rank in
    ``comm``. Reductions and gathers run over the whole group in its rank
    order, as ``comm``'s do; :meth:`axis` is the ``ProcessComm`` of the
    grid line through this rank along one axis, whose rank is this rank's
    coordinate there.

    Every rank creates every line's ``torch.distributed`` group, the lines
    it is not on too, in the same order (axis by axis, lines in C order):
    a rank that skipped one would leave its peers waiting. The grid covers
    the group exactly."""

    def __init__(self, comm: ProcessComm, shape, axis_names):
        shape = tuple(int(s) for s in shape)
        names = tuple(axis_names)
        if len(shape) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"a grid needs one distinct name an axis, got "
                             f"shape {shape} and names {names}")
        n = int(np.prod(shape))
        if n > comm.size:
            raise ValueError(f"requested {n} grid ranks but only "
                             f"{comm.size} available")
        if n != comm.size:
            raise ValueError(f"requested {n} grid ranks but the group has "
                             f"{comm.size}: a grid covers every rank")
        self._axes = {}
        super().__init__(comm.group)
        self.shape, self.axis_names = shape, names
        self.coords = tuple(int(c) for c in np.unravel_index(self.rank,
                                                             shape))
        ranks = np.arange(n).reshape(shape)
        for ax, name in enumerate(names):
            for line in np.moveaxis(ranks, ax, -1).reshape(-1, shape[ax]):
                group = dist.new_group([self.peer(int(r)) for r in line])
                if self.rank in line:
                    self._axes[name] = ProcessComm(group)
            assert self._axes[name].rank == self.coords[ax]

    @property
    def staged_bytes(self) -> int:
        """Bytes staged through the host by the grid's own collectives and
        by its axes' exchanges; setting it sets the grid's count and zeroes
        the axes'."""
        return self._staged + sum(c.staged_bytes for c in self._axes.values())

    @staged_bytes.setter
    def staged_bytes(self, value: int) -> None:
        self._staged = value
        for c in self._axes.values():
            c.staged_bytes = 0

    def axis(self, name: str) -> ProcessComm:
        return self._axes[name]

    def axis_size(self, name: str) -> int:
        return self.shape[self.axis_names.index(name)]

    def coord(self, name: str) -> int:
        return self.coords[self.axis_names.index(name)]

    def coords_of(self, rank: int) -> tuple:
        """The grid coordinates of ``rank`` of the group."""
        return tuple(int(c) for c in np.unravel_index(rank, self.shape))

    def __repr__(self):
        return (f"ProcessGrid(rank={self.rank}, shape={self.shape}, "
                f"axes={self.axis_names}, backend={self.backend!r})")


def dot(comm: Comm, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Global columnwise dot: local dot, then one psum (the lclDot +
    reduceAll split of Tpetra::MultiVector::dot)."""
    return comm.psum(local_dot(x, y))


def norm2(comm: Comm, x: torch.Tensor) -> torch.Tensor:
    """Global 2-norm (columnwise for a multivector): local dot, one psum."""
    return torch.sqrt(dot(comm, x, x))


def fused_dots(comm: Comm, pairs) -> torch.Tensor:
    """Several dot products in one reduction: the local partials stacked,
    one psum (Belos' single-reduce fusions)."""
    return comm.psum(torch.stack([local_dot(x, y) for (x, y) in pairs]))
