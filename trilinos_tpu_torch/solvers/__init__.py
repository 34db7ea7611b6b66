from .base import Operator, SolveResult, identity_prec
from .bicgstab import bicgstab
from .block_cg import block_cg
from .block_gcrodr import block_gcrodr
from .block_gmres import block_gmres
from .cg import cg, cg_fused, cg_pipeline, cg_single_reduce, stochastic_cg
from .direct import NotSpdError, SparseCholesky, SparseLu, direct_solve
from .gcrodr import RecycleSpace, gcrodr
from .gmres import fgmres, gmres
from .gmres_ca import gmres_pipeline, gmres_single_reduce
from .linear_problem import LinearProblem
from .lsqr import fixed_point, lsqr
from .minres import minres
from .pliris import dense_solve, dist_dense_solve
from .rcg import CgRecycleSpace, pcpg, rcg
from .sstep_gmres import sstep_gmres
from .tfqmr import tfqmr
from .factory import SolverManager, build, create_solver, solver_names
from . import ortho, status

__all__ = ["CgRecycleSpace", "LinearProblem", "NotSpdError", "Operator",
           "RecycleSpace", "SolveResult", "SolverManager", "SparseCholesky",
           "SparseLu", "bicgstab", "block_cg",
           "block_gcrodr", "block_gmres", "build", "cg", "cg_fused",
           "cg_pipeline", "cg_single_reduce", "create_solver", "dense_solve",
           "direct_solve", "dist_dense_solve", "fgmres",
           "fixed_point", "gcrodr", "gmres", "gmres_pipeline",
           "gmres_single_reduce", "identity_prec", "lsqr", "minres",
           "ortho", "pcpg", "rcg", "solver_names", "sstep_gmres", "status",
           "stochastic_cg", "tfqmr"]
