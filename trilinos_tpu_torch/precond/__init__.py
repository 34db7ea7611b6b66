from .amg import SaAmg
from .base import Preconditioner
from .chebyshev import fused_stencil_chebyshev

__all__ = ["Preconditioner", "SaAmg", "fused_stencil_chebyshev"]
