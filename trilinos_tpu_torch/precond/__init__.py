from .amg import SaAmg
from .base import Preconditioner, create
from .block_amg import BlockStructuredAmg
from .chebyshev import Chebyshev, fused_stencil_chebyshev
from .jacobi import BlockJacobi, Relaxation
from .poly import GmresPoly, gmres_poly_op

__all__ = ["BlockJacobi", "BlockStructuredAmg", "Chebyshev", "GmresPoly",
           "Preconditioner", "Relaxation", "SaAmg", "create",
           "fused_stencil_chebyshev", "gmres_poly_op"]
