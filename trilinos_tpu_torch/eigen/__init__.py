from .lanczos import arnoldi, lanczos_eigs
from .lobpcg import EigenResult, lobpcg, power_method
from .krylov_schur import EigsResult, block_krylov_schur
from .davidson import block_davidson
from .gen_davidson import generalized_davidson
from .tracemin import tracemin
from .rtr import rtr
from .spectral import eigs_near, shift_invert
from .factory import (EigenProblem, EigenSolverManager, create_eigensolver,
                      eigensolver_names)

__all__ = ["arnoldi", "lanczos_eigs", "EigenResult", "lobpcg",
           "power_method", "EigsResult", "block_krylov_schur",
           "block_davidson", "generalized_davidson", "tracemin", "rtr",
           "shift_invert", "eigs_near"]
