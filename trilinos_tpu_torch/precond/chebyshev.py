"""Chebyshev polynomial smoothing on a matrix-free stencil.

Counterpart of ``fused_stencil_chebyshev`` in
``trilinos_tpu/precond/chebyshev.py`` (the analogue of Ifpack2::Chebyshev:
λmax from a power method on D⁻¹A unless given, λmin = λmax / ratio). The
degree-d semi-iteration with a zero initial guess is one stencil
polynomial apply (``ops/stencil_poly.py``). The ``Chebyshev`` class for
stored matrices needs ``choose_format`` and comes with it (ROADMAP.md
queue 1 item 5).
"""
from __future__ import annotations

from ..ops.stencil_op import StencilOp
from ..ops.stencil_poly import stencil_chebyshev_setup, stencil_poly_apply


def fused_stencil_chebyshev(op: StencilOp, degree: int,
                            lmax: float | None = None,
                            lmin: float | None = None, ratio: float = 30.0,
                            boost: float = 1.1, eig_iters: int = 10,
                            device=None):
    """Chebyshev preconditioner apply ``b -> p(A) b`` for a stencil with a
    constant diagonal, usable as ``prec=`` in any solver. ``lmax``/``lmin``
    bound the Jacobi-scaled operator D⁻¹A; without ``lmax`` the power
    method runs on ``device`` (``None`` means the CUDA card)."""
    if not isinstance(op, StencilOp):
        raise TypeError("fused_stencil_chebyshev expects a StencilOp")
    stages = stencil_chebyshev_setup(op, degree, lmax, lmin, ratio, boost,
                                     eig_iters, device)
    return lambda b: stencil_poly_apply(op, stages, b)
