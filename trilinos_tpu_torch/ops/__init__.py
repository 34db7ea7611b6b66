from .cg_fused import (cg_fused_applicable, cg_fused_iteration,
                       cg_fused_iteration_plain)
from .dia_spmv import dia_spmm, dia_spmv, dia_spmv_plain, dia_spmv_t_plain
from .formats import CsrHost, DiaMatrix, csr_to_dia
from .matvec import residual, spmm, spmv
from .matrix_ops import diag_matrix, ptap, spadd, spgemm
from .smalldense import chol_inv_small, chol_inv_small_plain
from .stencil_op import (StencilOp, stencil_spmm, stencil_spmv,
                         stencil_spmv_plain)
from .stencil_poly import (stencil_poly_apply, stencil_poly_plain,
                           stencil_powers_apply, stencil_powers_plain)

__all__ = [
    "CsrHost",
    "DiaMatrix",
    "StencilOp",
    "cg_fused_applicable",
    "cg_fused_iteration",
    "cg_fused_iteration_plain",
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
    "stencil_poly_apply",
    "stencil_poly_plain",
    "stencil_powers_apply",
    "stencil_powers_plain",
    "stencil_spmv_plain",
]
