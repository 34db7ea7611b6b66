from .amg import SaAmg
from .base import Preconditioner, create
from .block_amg import BlockStructuredAmg
from .chebyshev import fused_stencil_chebyshev
from .jacobi import BlockJacobi, Relaxation

__all__ = ["BlockJacobi", "BlockStructuredAmg", "Preconditioner",
           "Relaxation", "SaAmg", "create", "fused_stencil_chebyshev"]
