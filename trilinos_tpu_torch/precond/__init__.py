from .amg import SaAmg
from .base import Preconditioner
from .block_amg import BlockStructuredAmg
from .chebyshev import fused_stencil_chebyshev

__all__ = ["BlockStructuredAmg", "Preconditioner", "SaAmg",
           "fused_stencil_chebyshev"]
