"""Row-distribution maps.

Counterpart of ``trilinos_tpu/parallel/map.py`` (host numpy, copied): the
analogue of ``Tpetra::Map`` (the distribution of global row indices over
ranks, GID↔LID translation and owner lookup). Two contiguous modes:

* **uniform** (``Map.uniform``): owner-of-GID is a divide, the reference's
  ContiguousUniformDirectory;
* **nonuniform** (``Map.contiguous``): per-rank extents ``lows``; owner
  lookup is a search over the P+1 boundaries (the
  DistributedContiguousDirectory).

Arbitrary GID distributions compose a permutation
(``partition.partition_to_permutation`` + ``permute_csr``) with a
contiguous map; :class:`Directory` packages that composition as the
reference's noncontiguous GID → (owner, LID) lookup.

Every rank carries the same padded local length ``n_local_pad`` (a
multiple of ``ROW_ALIGN``); padding rows follow the identity-row
convention. A "global padded vector" is the concatenation of the P padded
local chunks, shape (P · n_local_pad,); :meth:`Map.to_padded` and
:meth:`Map.from_padded` translate between it and a host vector, and rank
s's local vector is chunk s.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..ops.formats import ROW_ALIGN, round_up


@dataclasses.dataclass(frozen=True)
class Map:
    """Contiguous row partition. Uniform mode (``lows is None``): rank s
    owns GIDs [chunk·s, min(chunk·(s+1), n_global)); nonuniform mode: rank s
    owns [lows[s], lows[s+1])."""

    n_global: int
    n_shards: int
    n_local_pad: int
    lows: tuple[int, ...] | None = None  # len P+1 when nonuniform

    @classmethod
    def uniform(cls, n_global: int, n_shards: int,
                align: int = ROW_ALIGN) -> "Map":
        chunk = -(-n_global // n_shards)
        return cls(n_global=n_global, n_shards=n_shards,
                   n_local_pad=round_up(chunk, align))

    @classmethod
    def contiguous(cls, sizes, align: int = ROW_ALIGN) -> "Map":
        """Nonuniform contiguous map from per-rank owned counts."""
        sizes = [int(s) for s in sizes]
        lows = tuple(np.concatenate([[0], np.cumsum(sizes)]).tolist())
        return cls(n_global=lows[-1], n_shards=len(sizes),
                   n_local_pad=round_up(max(max(sizes), 1), align),
                   lows=lows)

    @property
    def chunk(self) -> int:
        return -(-self.n_global // self.n_shards)

    def shard_lo(self, s: int) -> int:
        if self.lows is not None:
            return self.lows[s]
        return min(self.chunk * s, self.n_global)

    def shard_hi(self, s: int) -> int:
        if self.lows is not None:
            return self.lows[s + 1]
        return min(self.chunk * (s + 1), self.n_global)

    def n_owned(self, s: int) -> int:
        return self.shard_hi(s) - self.shard_lo(s)

    def owner_of(self, gids: np.ndarray) -> np.ndarray:
        if self.lows is not None:
            return (np.searchsorted(np.asarray(self.lows), gids,
                                    side="right") - 1).clip(0,
                                                            self.n_shards - 1)
        return np.minimum(np.asarray(gids) // self.chunk, self.n_shards - 1)

    def gid_to_lid(self, gids: np.ndarray, s: int) -> np.ndarray:
        """Local index (into the padded local chunk) of owned GIDs."""
        return np.asarray(gids) - self.shard_lo(s)

    @property
    def n_global_pad(self) -> int:
        return self.n_shards * self.n_local_pad

    # -- host-side layout helpers -----------------------------------------
    def to_padded(self, x: np.ndarray) -> np.ndarray:
        """Host (n_global, ...) → padded layout (P·n_local_pad, ...)."""
        x = np.asarray(x)
        out = np.zeros((self.n_global_pad,) + x.shape[1:], dtype=x.dtype)
        for s in range(self.n_shards):
            lo, hi = self.shard_lo(s), self.shard_hi(s)
            out[s * self.n_local_pad:s * self.n_local_pad + (hi - lo)] = x[lo:hi]
        return out

    def from_padded(self, xp: np.ndarray) -> np.ndarray:
        xp = np.asarray(xp)
        out = np.zeros((self.n_global,) + xp.shape[1:], dtype=xp.dtype)
        for s in range(self.n_shards):
            lo, hi = self.shard_lo(s), self.shard_hi(s)
            out[lo:hi] = xp[s * self.n_local_pad:s * self.n_local_pad + (hi - lo)]
        return out

    def local_chunk(self, xp: np.ndarray, s: int) -> np.ndarray:
        """Rank s's padded local part of a global padded vector."""
        return np.asarray(xp)[s * self.n_local_pad:(s + 1) * self.n_local_pad]


@dataclasses.dataclass(frozen=True)
class Directory:
    """GID → (owner, LID) lookup for arbitrary row numberings: a contiguous
    Map composed with the renumbering permutation (the role of Tpetra's
    DistributedNoncontiguousDirectory, realized as a host permutation).

    ``new_of_old[g]`` = position of original row g in the permuted
    contiguous numbering that ``map`` distributes.
    """

    map: Map
    new_of_old: np.ndarray

    def remote_index_list(self, gids) -> tuple[np.ndarray, np.ndarray]:
        """(owning rank, local index) per original GID — the analogue of
        Tpetra::Map::getRemoteIndexList."""
        new_ids = self.new_of_old[np.asarray(gids, dtype=np.int64)]
        owners = self.map.owner_of(new_ids)
        lids = new_ids - np.asarray([self.map.shard_lo(int(o))
                                     for o in owners])
        return owners, lids
