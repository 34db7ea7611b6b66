"""Dense vector kernels (local part): dots and axpby.

Counterpart of ``trilinos_tpu/ops/blas.py``. Multivectors are
(n_rows_pad, k) tensors whose padding rows stay zero. The JAX package pins
its GEMMs to exact f32 (``precision=HIGHEST``); the port's counterpart is
the float32 matmul setting made when the package is imported (TF32 off).
"""
from __future__ import annotations

import torch


def axpby(alpha, x: torch.Tensor, beta, y: torch.Tensor) -> torch.Tensor:
    """alpha*x + beta*y."""
    return alpha * x + beta * y


def local_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Columnwise dot of two (n, k) multivectors → (k,); 0-d for (n,)."""
    if x.ndim == 1:
        return torch.dot(x, y)
    return (x * y).sum(dim=0)


def local_norm2_sq(x: torch.Tensor) -> torch.Tensor:
    return local_dot(x, x)
