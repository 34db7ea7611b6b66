from .base import SolveResult
from .cg import cg

__all__ = ["SolveResult", "cg"]
