from .base import SolveResult
from .block_gmres import block_gmres
from .cg import cg

__all__ = ["SolveResult", "block_gmres", "cg"]
