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

The transport is fixed when a ``ProcessComm`` is made and never changes
while it runs. ``nccl`` moves device buffers as they are and refuses a CPU
tensor. ``gloo`` moves CPU tensors as they are; a CUDA tensor is staged
through host memory on every collective (gloo's all-to-all and
point-to-point take CPU tensors only), and ``staged_bytes`` counts the
bytes that went through the host, both ways.
"""
from __future__ import annotations

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
