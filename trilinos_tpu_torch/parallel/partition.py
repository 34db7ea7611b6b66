"""Partitioning, ordering and colouring (Zoltan2-lite).

Counterpart of ``trilinos_tpu/parallel/partition.py`` (host numpy, copied):

* ``partition_rcb``: recursive coordinate bisection (Zoltan's RCB);
* ``partition_multijagged``: p-way multisection along each coordinate axis
  in turn (Zoltan2's MultiJagged);
* ``partition_greedy_graph``: BFS region growing over the matrix graph;
* ``partition_lines``: Ifpack2's LinePartitioner (strongest-connection
  lines for line smoothing);
* ``order_rcm``: reverse Cuthill–McKee ordering;
* ``color_distance2``: greedy distance-2 colouring;
* ``partition_quality``: edge cut and imbalance;
* ``permute_csr`` / ``partition_to_permutation``: renumber a matrix so a
  computed partition becomes contiguous, which is what
  ``distmatrix.distribute`` (contiguous maps) consumes.
"""
from __future__ import annotations

import numpy as np

from ..ops.formats import CsrHost


def partition_rcb(coords: np.ndarray, n_parts: int) -> np.ndarray:
    """Recursive coordinate bisection: coords (n, d) → part id per row.
    n_parts may be any positive integer (uneven splits weighted)."""
    coords = np.asarray(coords, dtype=np.float64)
    n = coords.shape[0]
    part = np.zeros(n, dtype=np.int64)

    def rec(idx: np.ndarray, parts: int, base: int):
        if parts <= 1 or len(idx) == 0:
            part[idx] = base
            return
        left_parts = parts // 2
        frac = left_parts / parts
        c = coords[idx]
        widths = c.max(axis=0) - c.min(axis=0)
        axis = int(np.argmax(widths))
        order = np.argsort(c[:, axis], kind="stable")
        cut = int(round(frac * len(idx)))
        rec(idx[order[:cut]], left_parts, base)
        rec(idx[order[cut:]], parts - left_parts, base + left_parts)

    rec(np.arange(n), n_parts, 0)
    return part


def partition_multijagged(coords: np.ndarray, parts_per_dim) -> np.ndarray:
    """MultiJagged coordinate partitioning: p-way multisection along each
    axis in sequence (Zoltan2_AlgMultiJagged.hpp). Unlike RCB's recursive
    2-way cuts, MJ cuts axis 0 into ``parts_per_dim[0]`` equal-weight
    slabs at once, then each slab along axis 1, … — the per-axis cut is a
    single weighted-quantile computation, fully vectorized.

    parts_per_dim: int sequence, one entry per coordinate axis (extra
    axes uncut). Total parts = prod(parts_per_dim).
    """
    coords = np.asarray(coords, dtype=np.float64)
    n, d = coords.shape
    ppd = list(parts_per_dim)
    if len(ppd) > d:
        raise ValueError(f"parts_per_dim has {len(ppd)} entries for "
                         f"{d}-dimensional coordinates")
    part = np.zeros(n, dtype=np.int64)
    for axis, p in enumerate(ppd):
        if p <= 1:
            continue
        new_part = np.empty(n, dtype=np.int64)
        # cut every current part independently along this axis
        order = np.argsort(part, kind="stable")
        bounds = np.searchsorted(part[order], np.arange(part.max() + 2))
        for b in range(len(bounds) - 1):
            idx = order[bounds[b]:bounds[b + 1]]
            if len(idx) == 0:
                continue
            # equal-count multisection = quantile cuts (uniform weights)
            ranks = np.argsort(np.argsort(coords[idx, axis], kind="stable"))
            slab = (ranks * p) // len(idx)
            new_part[idx] = part[idx] * p + slab
        part = new_part
    # compact part ids (empty slabs possible only for n < total parts)
    _, part = np.unique(part, return_inverse=True)
    return part.astype(np.int64)


def partition_greedy_graph(a: CsrHost, n_parts: int) -> np.ndarray:
    """BFS region growing: grow each part to ~n/n_parts nodes following
    graph adjacency; leftovers appended to the last part."""
    n = a.shape[0]
    target = -(-n // n_parts)
    part = np.full(n, -1, dtype=np.int64)
    visited = np.zeros(n, dtype=bool)
    cur_part = 0
    count = 0
    from collections import deque

    queue: deque = deque()
    for seed in range(n):
        if visited[seed]:
            continue
        queue.append(seed)
        visited[seed] = True
        while queue:
            i = queue.popleft()
            part[i] = cur_part
            count += 1
            if count >= target and cur_part < n_parts - 1:
                cur_part += 1
                count = 0
                # restart BFS frontier into the new part
            cols, _ = a.row(i)
            for c in cols:
                c = int(c)
                if 0 <= c < n and not visited[c]:
                    visited[c] = True
                    queue.append(c)
    return part


def partition_to_permutation(part: np.ndarray) -> np.ndarray:
    """perm[new_index] = old_index, grouping rows of each part
    contiguously (stable within parts)."""
    return np.argsort(part, kind="stable")


def permute_csr(a: CsrHost, perm: np.ndarray) -> CsrHost:
    """B = A[perm, perm]: rows and columns renumbered so that new index k
    is old index ``perm[k]`` (EpetraExt's RowMatrix permutation)."""
    n = a.shape[0]
    inv = np.empty(n, dtype=np.int64)
    inv[np.asarray(perm)] = np.arange(n)
    return CsrHost.from_coo(inv[a._rows()], inv[a.cols.astype(np.int64)],
                            a.vals, a.shape, sum_duplicates=False)


def order_rcm(a: CsrHost) -> np.ndarray:
    """Reverse Cuthill–McKee ordering: perm[new] = old, minimizing matrix
    bandwidth (Zoltan2 ordering scope, zoltan2/src/algorithms/order/).
    BFS from a minimum-degree peripheral seed, neighbors visited in
    degree order; the final order is reversed. Reduces fill for
    ILU/banded containers and halo width for 1-D partitions."""
    from collections import deque

    n = a.shape[0]
    deg = np.asarray(a.row_lengths(), dtype=np.int64)
    visited = np.zeros(n, dtype=bool)
    out = np.empty(n, dtype=np.int64)
    pos = 0
    for comp_seed in np.argsort(deg, kind="stable"):
        if visited[comp_seed]:
            continue
        queue = deque([int(comp_seed)])
        visited[comp_seed] = True
        while queue:
            i = queue.popleft()
            out[pos] = i
            pos += 1
            cols, _ = a.row(i)
            nbrs = [int(c) for c in cols if 0 <= c < n and not visited[c]]
            for c in sorted(nbrs, key=lambda c: deg[c]):
                visited[c] = True
                queue.append(c)
    return out[::-1].copy()


def color_distance2(a: CsrHost) -> np.ndarray:
    """Greedy distance-2 coloring: no two rows sharing a neighbor get the
    same color (KokkosGraph_Distance2Color.hpp — used for structurally-
    orthogonal column groups in Jacobian estimation and aggregation)."""
    n = a.shape[0]
    color = np.full(n, -1, dtype=np.int64)
    adj = [a.row(i)[0] for i in range(n)]
    for i in range(n):
        forbidden = set()
        for c in adj[i]:
            c = int(c)
            if not 0 <= c < n:
                continue
            if color[c] >= 0:
                forbidden.add(color[c])
            for c2 in adj[c]:
                c2 = int(c2)
                if 0 <= c2 < n and color[c2] >= 0:
                    forbidden.add(color[c2])
        col = 0
        while col in forbidden:
            col += 1
        color[i] = col
    return color


def partition_lines(a: CsrHost, line_length: int) -> np.ndarray:
    """Ifpack2 LinePartitioner analogue (Ifpack2_LinePartitioner_decl.hpp):
    chain rows along their strongest off-diagonal connection into "lines"
    of up to ``line_length`` rows, for line smoothing (reorder with
    ``partition_to_permutation`` + a TriDi container of that block size).
    Returns a part id per row; every part has exactly ``line_length``
    members except possibly the last (pad-friendly for BlockRelaxation)."""
    n = a.shape[0]
    # strongest neighbor of each row (largest |a_ij|, j != i)
    strongest = np.full(n, -1, dtype=np.int64)
    strength = np.zeros(n)
    for i in range(n):
        cols, vals = a.row(i)
        best, bv = -1, 0.0
        for c, v in zip(cols, vals):
            c = int(c)
            if c != i and 0 <= c < n and abs(v) > bv:
                best, bv = c, abs(v)
        strongest[i] = best
        strength[i] = bv
    used = np.zeros(n, dtype=bool)
    line_of = np.full(n, -1, dtype=np.int64)
    next_line = 0
    # seed lines from the strongest connections first
    for seed in np.argsort(-strength, kind="stable"):
        if used[seed]:
            continue
        chain = [int(seed)]
        used[seed] = True
        while len(chain) < line_length:
            nxt = int(strongest[chain[-1]])
            if nxt < 0 or used[nxt]:
                break
            chain.append(nxt)
            used[nxt] = True
        for i in chain:
            line_of[i] = next_line
        next_line += 1
    # merge short lines into full-length parts (stable repack)
    order = np.argsort(line_of, kind="stable")
    part = np.empty(n, dtype=np.int64)
    part[order] = np.arange(n) // line_length
    return part


def partition_quality(a: CsrHost, part: np.ndarray) -> dict:
    """Edge-cut and imbalance metrics (Zoltan2 EvaluatePartition analogue)."""
    rows = np.repeat(np.arange(a.shape[0], dtype=np.int64),
                     a.row_lengths())
    cut = int((part[rows] != part[a.cols]).sum())
    counts = np.bincount(part)
    imbalance = float(counts.max() / max(counts.mean(), 1e-300))
    return dict(edge_cut=cut, imbalance=imbalance,
                part_sizes=counts.tolist())
