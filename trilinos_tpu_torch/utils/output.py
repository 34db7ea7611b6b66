"""Verbosity-gated, rank-aware output.

Counterpart of ``trilinos_tpu/utils/output.py`` (``Belos::OutputManager``:
a verbosity bitmask ``MsgType`` and rank-0-only printing). The rank is
``torch.distributed.get_rank()`` when a process group is initialised, and
0 otherwise.
"""
from __future__ import annotations

import enum
import sys

import torch


class MsgType(enum.IntFlag):
    """Verbosity bitmask, mirroring Belos' MsgType semantics."""

    ERRORS = 1
    WARNINGS = 2
    ITERATION_DETAILS = 4
    ORTHO_DETAILS = 8
    FINAL_SUMMARY = 16
    TIMING_DETAILS = 32
    STATUS_TEST_DETAILS = 64
    DEBUG = 128


class OutputManager:
    def __init__(self, verbosity: int = MsgType.ERRORS, stream=None,
                 rank0_only=True):
        self.verbosity = int(verbosity)
        self.stream = stream if stream is not None else sys.stdout
        self.rank0_only = rank0_only

    def _is_rank0(self) -> bool:
        dist = torch.distributed
        if dist.is_available() and dist.is_initialized():
            return dist.get_rank() == 0
        return True

    def is_verbosity(self, msg_type: int) -> bool:
        return bool(self.verbosity & int(msg_type))

    def print(self, msg_type: int, message: str) -> None:
        if self.is_verbosity(msg_type) and (not self.rank0_only
                                            or self._is_rank0()):
            print(message, file=self.stream)
