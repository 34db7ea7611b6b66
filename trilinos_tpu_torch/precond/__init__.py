from .amg import SaAmg
from .base import Preconditioner, create
from .block_amg import BlockStructuredAmg
from .chebyshev import Chebyshev, fused_stencil_chebyshev
from .containers import BlockRelaxation
from .hiptmair import Hiptmair
from .ilu import Ilu0, ilu0_factor, iluk_augment, iluk_pattern, rbiluk_augment
from .ilut import Ilut, ilut_factor
from .jacobi import BlockJacobi, Relaxation
from .multicolor_gs import MulticolorGaussSeidel, greedy_color
from .poly import GmresPoly, gmres_poly_op
from .schwarz import AdditiveSchwarz

__all__ = ["AdditiveSchwarz", "BlockJacobi", "BlockRelaxation",
           "BlockStructuredAmg", "Chebyshev", "GmresPoly", "Hiptmair", "Ilu0",
           "Ilut", "MulticolorGaussSeidel", "Preconditioner", "Relaxation",
           "SaAmg", "create", "fused_stencil_chebyshev", "gmres_poly_op",
           "greedy_color", "ilu0_factor", "ilut_factor", "iluk_augment",
           "iluk_pattern", "rbiluk_augment"]
