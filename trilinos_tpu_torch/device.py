"""Device and dtype resolution shared by the port's entry points.

Every entry point that places tensors takes ``device=``. ``None`` means
the CUDA card; with no card the call raises instead of running on the CPU
unasked. Tests pass ``device="cpu"``.
"""
from __future__ import annotations

import numpy as np
import torch

_NUMPY_TO_TORCH = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda`` (raises without a card); else ``torch.device``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        return torch.device("cuda")
    return torch.device(device)


def torch_dtype(dtype) -> torch.dtype:
    """Map a torch dtype, numpy dtype or dtype name to a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _NUMPY_TO_TORCH[np.dtype(dtype)]
    except (KeyError, TypeError):
        raise TypeError(f"unsupported dtype {dtype!r}") from None


def numpy_dtype(dtype) -> np.dtype:
    """Host dtype used to assemble values before they go to ``dtype``
    (float32 stays float32; anything else is assembled in float64)."""
    td = torch_dtype(dtype)
    return np.dtype(np.float32) if td == torch.float32 else np.dtype(
        np.float64)
