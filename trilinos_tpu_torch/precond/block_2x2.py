"""Blocked operators and 2×2 block preconditioners.

Counterpart of ``trilinos_tpu/precond/block_2x2.py``: Xpetra's
BlockedCrsMatrix as a grid of four sub-operators, and Teko's block
preconditioner factories (Teko_BlockPreconditionerFactory.hpp: block
Jacobi and Gauss-Seidel, the SIMPLE-style approximate Schur complement and
the Navier-Stokes least-squares commutator of teko/src/NS/). Every
sub-operator and block inverse is a callable on tensors (any port
preconditioner, solver or closure), so AMG on A00 and Jacobi on A11
compose directly; vectors split at ``split`` rows.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

Op = Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass
class BlockedOperator2x2:
    """y = [[a00, a01], [a10, a11]] @ [x0; x1] with x split at ``split``."""

    a00: Op
    a01: Op
    a10: Op
    a11: Op
    split: int  # rows of the first block (padded)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x0, x1 = x[:self.split], x[self.split:]
        return torch.cat([self.a00(x0) + self.a01(x1),
                          self.a10(x0) + self.a11(x1)])


def block_diagonal_prec(inv00: Op, inv11: Op, split: int) -> Op:
    """Teko block Jacobi: M⁻¹ = diag(Â00⁻¹, Â11⁻¹)."""

    def apply(r):
        return torch.cat([inv00(r[:split]), inv11(r[split:])])

    return apply


def block_lower_triangular_prec(inv00: Op, a10: Op, inv11: Op,
                                split: int) -> Op:
    """Teko block Gauss-Seidel (lower): Â00 y0 = r0, then
    Â11 y1 = r1 − A10 y0."""

    def apply(r):
        y0 = inv00(r[:split])
        return torch.cat([y0, inv11(r[split:] - a10(y0))])

    return apply


def simple_schur_2x2(inv00: Op, a01: Op, a10: Op, inv_schur: Op,
                     split: int) -> Op:
    """SIMPLE-style approximate block LU (Teko's NS family):
    y0' = Â00⁻¹ r0; y1 = Ŝ⁻¹ (r1 − A10 y0') with Ŝ ≈ A11 − A10 Â00⁻¹ A01;
    y0 = y0' − Â00⁻¹ (A01 y1)."""

    def apply(r):
        y0p = inv00(r[:split])
        y1 = inv_schur(r[split:] - a10(y0p))
        return torch.cat([y0p - inv00(a01(y1)), y1])

    return apply


def lsc_inv_schur(inv_bqbt: Op, b: Op, f: Op, bt: Op,
                  qinv: Op | None = None) -> Op:
    """Teko's least-squares-commutator Schur inverse
    (Teko_LSCPreconditionerFactory.hpp) for [[F, Bᵀ], [B, 0]], S = −B F⁻¹ Bᵀ:

        S⁻¹ ≈ −(B Q⁻¹ Bᵀ)⁻¹ (B Q⁻¹ F Q⁻¹ Bᵀ) (B Q⁻¹ Bᵀ)⁻¹

    ``inv_bqbt`` solves with B Q⁻¹ Bᵀ, ``qinv`` is the (lumped) velocity
    mass inverse (identity if None). Exact when F commutes with the
    projection (F = c I); it plugs into :func:`simple_schur_2x2`."""
    qi = qinv or (lambda v: v)

    def inv_schur(r):
        return -inv_bqbt(b(qi(f(qi(bt(inv_bqbt(r)))))))

    return inv_schur


def diag_schur_approx(a11_diag_inv: torch.Tensor, a10: Op, a01: Op,
                      a00_diag_inv: torch.Tensor) -> Op:
    """The cheap Ŝ⁻¹ of the reference: one Jacobi sweep on diag(A11) (the
    other arguments are taken for the reference's signature and not
    read)."""

    def inv_schur(r):
        d = a11_diag_inv if r.ndim == 1 else a11_diag_inv[:, None]
        return d * r

    return inv_schur
