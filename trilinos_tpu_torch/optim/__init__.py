"""Smooth optimization (ROL analogue): trust-region Newton-CG, L-BFGS,
bound-constrained spectral projected gradient, augmented Lagrangian.
Counterpart of ``trilinos_tpu/optim``.

All methods take a plain torch scalar objective; gradients and
Hessian-vector products are exact autodiff (``optim/base.py``)."""
from .base import OptimizeResult
from .bounds import projected_gradient
from .lbfgs import lbfgs
from .trust_region import trust_region_newton
from .auglag import augmented_lagrangian

__all__ = [
    "OptimizeResult",
    "trust_region_newton",
    "lbfgs",
    "projected_gradient",
    "augmented_lagrangian",
]
