from .base import SolveResult
from .block_gmres import block_gmres
from .cg import cg, cg_fused, cg_single_reduce
from .sstep_gmres import sstep_gmres

__all__ = ["SolveResult", "block_gmres", "cg", "cg_fused",
           "cg_single_reduce", "sstep_gmres"]
