from .stencils import (
    laplace1d,
    laplace2d,
    laplace3d,
    stencil_csr,
    stencil_dia,
)

__all__ = ["laplace1d", "laplace2d", "laplace3d", "stencil_csr",
           "stencil_dia"]
