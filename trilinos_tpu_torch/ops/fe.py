"""Finite-element assembly on the host.

Counterpart of ``fe_assemble`` in ``trilinos_tpu/ops/fe.py`` (the analogue
of Tpetra's FE assembly with an Export-sum at endFill): element matrices
(ne, k, k) with connectivity (ne, k) expand to COO triples, and
``CsrHost.from_coo``'s duplicate sum is the Export-sum. The device-side
matrix-free ``fe_apply_local`` is not ported yet (ROADMAP.md queue 1
item 11).
"""
from __future__ import annotations

import numpy as np

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
