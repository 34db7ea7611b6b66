from .amg import SaAmg
from .base import Preconditioner

__all__ = ["Preconditioner", "SaAmg"]
