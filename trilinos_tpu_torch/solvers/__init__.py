from .base import SolveResult
from .block_gmres import block_gmres
from .cg import cg, cg_fused, cg_single_reduce
from .gmres import fgmres, gmres
from .gmres_ca import gmres_pipeline, gmres_single_reduce
from .linear_problem import LinearProblem
from .sstep_gmres import sstep_gmres

__all__ = ["LinearProblem", "SolveResult", "block_gmres", "cg", "cg_fused",
           "cg_single_reduce", "fgmres", "gmres", "gmres_pipeline",
           "gmres_single_reduce", "sstep_gmres"]
