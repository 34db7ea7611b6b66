"""Sparse direct solvers with the Amesos2 lifecycle.

Counterpart of ``trilinos_tpu/solvers/direct.py`` (Amesos2's
preOrdering/symbolicFactorization/numericFactorization/solve lifecycle,
Amesos2_SolverCore_decl.hpp, with the KLU2 default backend): host numpy
around the port's native C++ factorizations (``trilinos_tpu_torch/
native``). :class:`SparseLu` is Gilbert-Peierls LU with partial pivoting
(any square matrix), :class:`SparseCholesky` up-looking LLᵀ for symmetric
positive definite matrices (the Tacho/Cholmod role), which raises
:class:`NotSpdError` at the first non-positive reduced diagonal.

The factorization is set-up work and stays on the host, as in the
reference; the device sees a direct solver only through the dense inverse
of ``precond.DirectPrec`` or the coarse level of ``TwoLevelSchwarz``.
A block of right-hand sides is solved column by column with the
reference's arithmetic, the columns spread over the host's cores. Without
``g++`` (``native.lib()`` is None) ``SparseLu`` factors and solves with
scipy's ``splu`` and ``SparseCholesky`` with ``SparseLu``; each class
counts which path served in ``native_calls`` and ``python_calls``.
"""
from __future__ import annotations

import numpy as np

from ..native import (NotSpdError, spchol_native, spchol_solve_native,
                      splu_native, splu_solve_native)
from ..ops.formats import CsrHost

__all__ = ["NotSpdError", "SparseCholesky", "SparseLu", "direct_solve"]


class SparseLu:
    """create → symbolic/numeric factorization → solve (preOrdering is
    folded into the pivoting factorization)."""

    native_calls = 0
    python_calls = 0

    def __init__(self, a: CsrHost):
        if a.shape[0] != a.shape[1]:
            raise ValueError("SparseLu needs a square matrix")
        self.a = a
        self._factors = None
        self._scipy = None

    def symbolic_factorization(self) -> "SparseLu":
        # Gilbert-Peierls interleaves the symbolic and numeric work per
        # column; kept for the lifecycle
        return self

    def numeric_factorization(self) -> "SparseLu":
        a = self.a
        f = splu_native(a.shape[0], a.row_ptr, a.cols,
                        np.asarray(a.vals, dtype=np.float64))
        if f is not None:
            SparseLu.native_calls += 1
            self._factors = f
            return self
        SparseLu.python_calls += 1
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla

        m = sp.csr_matrix((np.asarray(a.vals, dtype=np.float64), a.cols,
                           a.row_ptr), shape=a.shape).tocsc()
        self._scipy = spla.splu(m)
        return self

    def factor(self) -> "SparseLu":
        return self.symbolic_factorization().numeric_factorization()

    def solve(self, b: np.ndarray) -> np.ndarray:
        """x with A x = b, float64, for a vector or an (n, k) block."""
        if self._factors is None and self._scipy is None:
            self.factor()
        if self._factors is not None:
            return splu_solve_native(self._factors, b)
        return self._scipy.solve(np.asarray(b, dtype=np.float64))

    @property
    def nnz_factors(self) -> int:
        if self._factors is not None:
            return int(self._factors[0][-1] + self._factors[3][-1])
        if self._scipy is not None:
            return int(self._scipy.L.nnz + self._scipy.U.nnz)
        return 0


class SparseCholesky:
    """Sparse LLᵀ with the Amesos2 lifecycle; the lower triangle of A is
    read. About half the fill and work of LU on SPD systems and no
    pivoting. Raises :class:`NotSpdError` (a ``ValueError``) on a matrix
    that is not positive definite."""

    native_calls = 0
    python_calls = 0

    def __init__(self, a: CsrHost):
        if a.shape[0] != a.shape[1]:
            raise ValueError("SparseCholesky needs a square matrix")
        self.a = a
        self._factors = None
        self._fallback = None

    def symbolic_factorization(self) -> "SparseCholesky":
        # the elimination tree is built inside the native call
        return self

    def numeric_factorization(self) -> "SparseCholesky":
        a = self.a
        f = spchol_native(a.shape[0], a.row_ptr, a.cols,
                          np.asarray(a.vals, dtype=np.float64))
        if f is not None:
            SparseCholesky.native_calls += 1
            self._factors = f
            return self
        SparseCholesky.python_calls += 1
        self._fallback = SparseLu(a).factor()
        return self

    def factor(self) -> "SparseCholesky":
        return self.symbolic_factorization().numeric_factorization()

    def solve(self, b: np.ndarray) -> np.ndarray:
        """x with A x = b, float64, for a vector or an (n, k) block."""
        if self._factors is None and self._fallback is None:
            self.factor()
        if self._fallback is not None:
            return self._fallback.solve(b)
        return spchol_solve_native(self._factors, b)

    @property
    def nnz_factors(self) -> int:
        if self._factors is not None:
            return int(self._factors[0][-1])
        if self._fallback is not None:
            return self._fallback.nnz_factors
        return 0


def direct_solve(a: CsrHost, b: np.ndarray) -> np.ndarray:
    """One-shot factor and solve (Amesos2::Solver::solve)."""
    return SparseLu(a).factor().solve(b)
