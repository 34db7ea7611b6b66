from .fem import (
    elasticity2d,
    elasticity3d,
    helmholtz2d,
    rigid_body_modes,
    uniflow2d,
)
from .stencils import (
    big_star2d,
    brick3d,
    create_matrix,
    laplace1d,
    laplace2d,
    laplace3d,
    maxwell2d,
    recirc2d,
    star2d,
    stencil_csr,
    stencil_dia,
)

__all__ = ["big_star2d", "brick3d", "create_matrix", "elasticity2d",
           "elasticity3d", "helmholtz2d", "laplace1d", "laplace2d",
           "laplace3d", "maxwell2d", "recirc2d", "rigid_body_modes", "star2d",
           "stencil_csr", "stencil_dia", "uniflow2d"]
