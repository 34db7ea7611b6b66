"""Finite-element assembly and the matrix-free element apply.

Counterpart of ``trilinos_tpu/ops/fe.py`` (the analogue of Tpetra's FE
assembly with an Export-sum at endFill):

* :func:`fe_assemble` and :func:`fe_assemble_vector` run on the host:
  element matrices (ne, k, k) with connectivity (ne, k) expand to COO
  triples, and ``CsrHost.from_coo``'s duplicate sum is the Export-sum;
  element vectors sum the same way;
* :func:`fe_apply_local` is the assembly-free apply
  y = Σ_e P_eᵀ K_e P_e x on the tensors' device: an index gather of the
  element dofs, one batched matmul in the element matrices' dtype and an
  ``index_add_`` back. It is plain torch on the card as on the CPU (the
  JAX package's version is a ``jnp`` gather, einsum and scatter-add,
  outside any Pallas kernel).
"""
from __future__ import annotations

import numpy as np
import torch

from .formats import CsrHost


def fe_assemble(connect: np.ndarray, elem_mats: np.ndarray,
                n_dofs: int) -> CsrHost:
    """Assemble element matrices into a global CSR.

    connect: (ne, k) global dof ids per element
    elem_mats: (ne, k, k) element stiffness matrices
    """
    connect = np.asarray(connect, dtype=np.int64)
    elem_mats = np.asarray(elem_mats)
    ne, k = connect.shape
    rows = np.repeat(connect, k, axis=1).reshape(-1)  # (ne*k*k,)
    cols = np.tile(connect, (1, k)).reshape(-1)
    vals = elem_mats.reshape(-1)
    return CsrHost.from_coo(rows, cols, vals, (n_dofs, n_dofs),
                            sum_duplicates=True)


def fe_assemble_vector(connect: np.ndarray, elem_vecs: np.ndarray,
                       n_dofs: int) -> np.ndarray:
    """Assemble element load vectors (ne, k) → global (n_dofs,) (the
    FEMultiVector endFill ADD combine)."""
    out = np.zeros(n_dofs, dtype=np.asarray(elem_vecs).dtype)
    np.add.at(out, np.asarray(connect, dtype=np.int64).reshape(-1),
              np.asarray(elem_vecs).reshape(-1))
    return out


def fe_apply_local(connect: torch.Tensor, elem_mats: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """Matrix-free FE operator apply y = Σ_e P_eᵀ K_e P_e x.

    ``connect`` (ne, k) integer dof ids, ``elem_mats`` (ne, k, k) and ``x``
    (n,) or (n, m), all on one device. The gathered (ne, k, m) element
    values are multiplied in ``elem_mats``' dtype and summed back into
    ``x``'s dtype; the result has ``x``'s shape.
    """
    was_1d = x.ndim == 1
    x2 = x[:, None] if was_1d else x
    gathered = x2[connect]  # (ne, k, m)
    local = torch.bmm(elem_mats, gathered.to(elem_mats.dtype))
    y = torch.zeros_like(x2)
    y.index_add_(0, connect.reshape(-1),
                 local.reshape(-1, x2.shape[1]).to(x2.dtype))
    return y[:, 0] if was_1d else y
