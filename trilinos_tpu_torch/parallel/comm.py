"""Communicator abstraction.

Counterpart of ``trilinos_tpu/parallel/comm.py``: the reduction surface
the solvers are written against. This slice is single-device, so only
``SerialComm`` exists; the ``torch.distributed`` communicator comes with
the distributed layer (ROADMAP.md, queue 1 item 10).
"""
from __future__ import annotations

import torch

from ..ops.blas import local_dot


class Comm:
    """Reduction surface the solver layer is written against (the slice's
    solvers need only the global sum)."""

    size: int

    def psum(self, x):
        raise NotImplementedError


class SerialComm(Comm):
    size = 1

    def psum(self, x):
        return x

    def __repr__(self):
        return "SerialComm()"


def norm2(comm: Comm, x: torch.Tensor) -> torch.Tensor:
    """Global 2-norm (columnwise for a multivector): local dot, one psum."""
    return torch.sqrt(comm.psum(local_dot(x, x)))
