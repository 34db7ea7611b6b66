"""Where a kernel wrapper sends a tensor.

A wrapper runs its plain PyTorch version for a tensor on the CPU and
launches its CUDA kernel for a tensor on the card; any other device
raises.
"""
from __future__ import annotations

import torch


def use_kernel(x: torch.Tensor) -> bool:
    kind = x.device.type
    if kind == "cpu":
        return False
    if kind == "cuda":
        return True
    raise ValueError(f"tensors on {x.device} are not supported")
