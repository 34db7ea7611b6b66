"""Nonlinear solvers and time integration (NOX/LOCA/Tempus analogue):
JFNK Newton, Anderson, dogleg trust region, parameter continuation,
implicit/explicit steppers. Counterpart of ``trilinos_tpu/nonlinear``;
Jacobian actions are ``torch.func`` JVPs and VJPs through the kernel
wrappers' derivative rules (``ops/autodiff.py``)."""
from .base import NonlinearResult, make_jvp_operator, make_vjp_operator
from .newton import newton_krylov
from .anderson import anderson
from .trust_region import newton_trust_region
from .continuation import ContinuationResult, continuation
from .integrators import (IntegratorResult, backward_euler, bdf2,
                          integrate_adaptive, rk4, sdirk2, theta_method,
                          trapezoidal)

__all__ = [
    "NonlinearResult",
    "make_jvp_operator",
    "make_vjp_operator",
    "newton_krylov",
    "anderson",
    "newton_trust_region",
    "continuation",
    "ContinuationResult",
    "IntegratorResult",
    "theta_method",
    "backward_euler",
    "trapezoidal",
    "bdf2",
    "sdirk2",
    "integrate_adaptive",
    "rk4",
]
