"""Local SpMV / SpMM dispatch over the port's operator formats.

Counterpart of ``trilinos_tpu/ops/matvec.py`` for the formats of the
port: the matrix-free :class:`StencilOp` and the stored :class:`DiaMatrix`
and :class:`BdiaMatrix`. x is (n_pad,) or (n_pad, k); y keeps the padding.
Vectors and multivectors on the card go through the hand-written kernels;
the DIA and BDIA transposes are plain PyTorch on every device, as the JAX
package leaves them to XLA.
"""
from __future__ import annotations

import torch

from .bdia_spmv import bdia_spmv, bdia_spmv_t_plain
from .dia_spmv import dia_spmv, dia_spmv_t_plain
from .formats import BdiaMatrix, DiaMatrix
from .stencil_op import StencilOp, stencil_spmv


def spmv(a, x: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """Local sparse matrix–(multi)vector product."""
    if isinstance(a, StencilOp):
        return stencil_spmv(a.transposed() if transpose else a, x)
    if isinstance(a, DiaMatrix):
        return dia_spmv_t_plain(a, x) if transpose else dia_spmv(a, x)
    if isinstance(a, BdiaMatrix):
        return bdia_spmv_t_plain(a, x) if transpose else bdia_spmv(a, x)
    raise TypeError(f"spmv: unsupported operator type {type(a).__name__}")


spmm = spmv  # multivector RHS is handled uniformly


def residual(a, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """r = b − A x."""
    return b - spmv(a, x)
