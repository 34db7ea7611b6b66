"""Local SpMV / SpMM dispatch over the port's operator formats.

Counterpart of ``trilinos_tpu/ops/matvec.py``: the matrix-free
:class:`StencilOp` and the stored :class:`EllMatrix`, :class:`DiaMatrix`,
:class:`BsrMatrix` and :class:`BdiaMatrix`. x is (n_pad,) or (n_pad, k); y
keeps the padding. Stencil, DIA and BDIA applies on the card go through the
hand-written kernels. ELL and BSR, and every transpose, are plain PyTorch
on every device, as the JAX package leaves them to XLA: ELL is a gather,
multiply and row sum; BSR gathers x panels and runs one batched matmul
per block row in the storage dtype (float32 matmuls stay in full
precision, TF32 off).
The ELL and BSR transposes scatter with ``index_add_``, which sums the
contributions to one row in another order than JAX's ``.at[].add``.
"""
from __future__ import annotations

import torch

from .bdia_spmv import bdia_spmv, bdia_spmv_t_plain
from .dia_spmv import dia_spmv, dia_spmv_t_plain
from .formats import BdiaMatrix, BsrMatrix, DiaMatrix, EllMatrix
from .stencil_op import StencilOp, stencil_spmv


def _ensure_2d(x: torch.Tensor):
    return (x[:, None], True) if x.ndim == 1 else (x, False)


def _restore(y: torch.Tensor, was_1d: bool) -> torch.Tensor:
    return y[:, 0] if was_1d else y


def ell_spmm(a: EllMatrix, x: torch.Tensor) -> torch.Tensor:
    """y[i] = Σ_k vals[i, k] · x[cols[i, k]] (padding entries hold 0)."""
    x2, was_1d = _ensure_2d(x)
    gathered = x2[a.cols].to(a.dtype)  # (n_rows_pad, k, nrhs)
    return _restore((a.vals[:, :, None] * gathered).sum(dim=1), was_1d)


def ell_spmm_t(a: EllMatrix, x: torch.Tensor) -> torch.Tensor:
    """Transpose apply: y[cols[i, k]] += vals[i, k] · x[i] (scatter-add) into
    the padded row space."""
    x2, was_1d = _ensure_2d(x)
    n_out = a.n_rows_pad
    contrib = a.vals[:, :, None] * x2[:, None, :]
    y = torch.zeros((n_out, x2.shape[1]), dtype=contrib.dtype,
                    device=x2.device)
    y.index_add_(0, a.cols.reshape(-1), contrib.reshape(-1, x2.shape[1]))
    return _restore(y, was_1d)


def bsr_spmm(a: BsrMatrix, x: torch.Tensor) -> torch.Tensor:
    """Block SpMM: gather the x block panels, then one batched matmul per
    block row over its blocks (the reference's einsum; as nbr·kb separate
    b×b products and a sum it reads 2.9× slower on the H100,
    ``scripts/sweep_bsr.py``)."""
    x2, was_1d = _ensure_2d(x)
    b, nrhs = a.block_size, x2.shape[1]
    panels = x2.reshape(-1, b, nrhs)[a.bcols].to(a.dtype)  # (nbr, kb, b, k)
    y = torch.einsum("rkij,rkjn->rin", a.bvals, panels)
    return _restore(y.reshape(-1, nrhs), was_1d)


def bsr_spmm_t(a: BsrMatrix, x: torch.Tensor) -> torch.Tensor:
    """Transpose apply: block (r, s) adds bvals[r, s]ᵀ · x_r into block
    column bcols[r, s] (scatter-add)."""
    x2, was_1d = _ensure_2d(x)
    b, nrhs = a.block_size, x2.shape[1]
    xb = x2.reshape(-1, b, nrhs)[:a.n_brows_pad].to(a.dtype)
    contrib = torch.einsum("rkij,rin->rkjn", a.bvals, xb)
    n_bout = max(a.n_brows_pad, -(-a.n_cols // b))
    y = torch.zeros((n_bout, b, nrhs), dtype=contrib.dtype, device=x2.device)
    y.index_add_(0, a.bcols.reshape(-1), contrib.reshape(-1, b, nrhs))
    return _restore(y.reshape(-1, nrhs), was_1d)


def spmv(a, x: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """Local sparse matrix–(multi)vector product."""
    if isinstance(a, StencilOp):
        return stencil_spmv(a.transposed() if transpose else a, x)
    if isinstance(a, DiaMatrix):
        return dia_spmv_t_plain(a, x) if transpose else dia_spmv(a, x)
    if isinstance(a, BdiaMatrix):
        return bdia_spmv_t_plain(a, x) if transpose else bdia_spmv(a, x)
    if isinstance(a, EllMatrix):
        return ell_spmm_t(a, x) if transpose else ell_spmm(a, x)
    if isinstance(a, BsrMatrix):
        return bsr_spmm_t(a, x) if transpose else bsr_spmm(a, x)
    raise TypeError(f"spmv: unsupported operator type {type(a).__name__}")


spmm = spmv  # multivector RHS is handled uniformly


def residual(a, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """r = b − A x."""
    return b - spmv(a, x)
