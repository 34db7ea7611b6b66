from .fem import (
    elasticity2d,
    elasticity3d,
    helmholtz2d,
    rigid_body_modes,
    uniflow2d,
)
from .stencils import (
    laplace1d,
    laplace2d,
    laplace3d,
    stencil_csr,
    stencil_dia,
)

__all__ = ["elasticity2d", "elasticity3d", "helmholtz2d", "laplace1d",
           "laplace2d", "laplace3d", "rigid_body_modes", "stencil_csr",
           "stencil_dia", "uniflow2d"]
