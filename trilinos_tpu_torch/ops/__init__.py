from .dia_spmv import dia_spmm, dia_spmv, dia_spmv_plain, dia_spmv_t_plain
from .formats import CsrHost, DiaMatrix, csr_to_dia
from .matvec import residual, spmm, spmv
from .matrix_ops import diag_matrix, ptap, spadd, spgemm
from .smalldense import chol_inv_small, chol_inv_small_plain
from .stencil_op import (StencilOp, stencil_spmm, stencil_spmv,
                         stencil_spmv_plain)

__all__ = [
    "CsrHost",
    "DiaMatrix",
    "StencilOp",
    "chol_inv_small",
    "chol_inv_small_plain",
    "csr_to_dia",
    "dia_spmm",
    "dia_spmv",
    "dia_spmv_plain",
    "dia_spmv_t_plain",
    "diag_matrix",
    "ptap",
    "residual",
    "spadd",
    "spgemm",
    "spmm",
    "spmv",
    "stencil_spmm",
    "stencil_spmv",
    "stencil_spmv_plain",
]
