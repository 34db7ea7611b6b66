"""Matrix renumbering for partitions and orderings.

Counterpart of one function of ``trilinos_tpu/parallel/partition.py``:
``permute_csr``, the symmetric permutation that ``ops.filters.
reorder_filter`` needs. The rest of that module (the RCB, MultiJagged,
graph and line partitioners, RCM ordering, distance-2 colouring) belongs
to the distributed layer, not ported yet (ROADMAP.md queue 1 item 10).
"""
from __future__ import annotations

import numpy as np

from ..ops.formats import CsrHost


def permute_csr(a: CsrHost, perm: np.ndarray) -> CsrHost:
    """B = A[perm, perm]: rows and columns renumbered so that new index k
    is old index ``perm[k]`` (EpetraExt's RowMatrix permutation)."""
    n = a.shape[0]
    inv = np.empty(n, dtype=np.int64)
    inv[np.asarray(perm)] = np.arange(n)
    return CsrHost.from_coo(inv[a._rows()], inv[a.cols.astype(np.int64)],
                            a.vals, a.shape, sum_duplicates=False)
