from .amg import SaAmg
from .base import Preconditioner, create
from .block_amg import BlockStructuredAmg
from .chebyshev import Chebyshev, fused_stencil_chebyshev
from .block_2x2 import (BlockedOperator2x2, block_diagonal_prec,
                        block_lower_triangular_prec, diag_schur_approx,
                        lsc_inv_schur, simple_schur_2x2)
from .containers import BlockRelaxation
from .direct_prec import DirectPrec
from .hiptmair import Hiptmair
from .ilu import Ilu0, ilu0_factor, iluk_augment, iluk_pattern, rbiluk_augment
from .ilut import Ilut, ilut_factor
from .jacobi import BlockJacobi, Relaxation
from .multicolor_gs import MulticolorGaussSeidel, greedy_color
from .poly import GmresPoly, gmres_poly_op
from .schwarz import AdditiveSchwarz
from .two_level_schwarz import TwoLevelSchwarz

__all__ = ["AdditiveSchwarz", "BlockJacobi", "BlockRelaxation",
           "BlockStructuredAmg", "BlockedOperator2x2", "Chebyshev",
           "DirectPrec", "GmresPoly", "Hiptmair", "Ilu0", "Ilut",
           "MulticolorGaussSeidel", "Preconditioner", "Relaxation", "SaAmg",
           "TwoLevelSchwarz", "block_diagonal_prec",
           "block_lower_triangular_prec", "create", "diag_schur_approx",
           "fused_stencil_chebyshev", "gmres_poly_op", "greedy_color",
           "ilu0_factor", "ilut_factor", "iluk_augment", "iluk_pattern",
           "lsc_inv_schur", "rbiluk_augment", "simple_schur_2x2"]
