"""The k-mer -> tax-value table: the database's core data structure.

Reference equivalent: core store/KMerSortedArray.java — a sorted long[] of
k-mers plus a parallel short[] of value indexes, looked up by binary search,
with value<->index maps shared via store/AbstractKMerStore.java.

TPU-native redesign:
  * The table is built host-side by exact sort-unique over numpy uint64
    (replacing the reference's bloom-filter dedup + quicksort,
    ref: KMerSortedArray.putLong:168-202/optimize:362-423 — the reference's
    fill bloom filter has fpp 1e-11, i.e. it *approximates* exact dedup; we
    just do exact dedup).
  * Lookups run on device over (hi, lo) uint32 pair arrays — a vectorized
    branchless lower-bound binary search across all query lanes, avoiding
    64-bit emulation on TPU. Storage position (the sorted rank) is returned
    exactly like the reference's posStore (ref: KMerSortedArray.getLong:345),
    feeding unique counting.
  * The LCA update phase rewrites value indexes by position
    (ref: KMerSortedArray.update:218-267), done host-side in bulk.

Duplicate policy during build: first insertion wins, matching the reference
(a second putLong of the same k-mer is rejected by the fill filter).

Port note: this is the host half of genestrip_tpu/store/table.py. The
device upload (`device_arrays`) and the binary-search oracle
(`lookup_positions`) are not ported yet (ROADMAP queue 1).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np

# Maximum number of distinct values. The reference's sorted array caps at
# 65,535 (KMerSortedArray.MAX_VALUES) and its radix store at ~512k
# (RadixKMerStore.maxValuesForRadix); the TPU layout stores value indices in
# int32 host-side and packs them into the quotient-hash rows on device
# (store/hash.py caps at 2^(nb_bits-1)-1, which the hash builder widens to
# fit) — 4M values covers bacteria-scale databases with room to spare.
MAX_VALUES = (1 << 22) - 1


class TableBuilder:
    """Accumulates (k-mer, value-index) chunks, then finalizes into a KmerTable.

    Value indices are assigned in first-encounter order, mirroring the
    reference's getAddValueIndex (ref: AbstractKMerStore.java:304-315).
    """

    def __init__(self, k: int):
        if not (1 <= k <= 31):
            raise ValueError(f"k must be in [1, 31], got {k}")
        self.k = k
        self._kmer_chunks: list[np.ndarray] = []
        self._vidx_chunks: list[np.ndarray] = []
        self.values: list[str] = []
        self.value_map: dict[str, int] = {}

    def get_add_value_index(self, value: str) -> int:
        idx = self.value_map.get(value)
        if idx is None:
            if len(self.values) >= MAX_VALUES:
                raise ValueError(f"Too many different values - only {MAX_VALUES} are possible.")
            idx = len(self.values)
            self.value_map[value] = idx
            self.values.append(value)
        return idx

    def add(self, kmers: np.ndarray, value: str) -> None:
        """Add a chunk of k-mers all mapped to one value."""
        if len(kmers) == 0:
            return
        vidx = self.get_add_value_index(value)
        self._kmer_chunks.append(np.asarray(kmers, dtype=np.uint64))
        self._vidx_chunks.append(np.full(len(kmers), vidx, dtype=np.int32))

    def add_pairs(self, kmers: np.ndarray, vidx: np.ndarray) -> None:
        """Add a chunk of (k-mer, value-index) pairs (indices must already exist).

        Deduplicated within the chunk (first pair wins; np.unique's
        return_index is the first occurrence) and stored sorted-by-k-mer with
        the values reordered alongside, so build() sees aligned chunks."""
        if len(kmers) == 0:
            return
        kmers = np.asarray(kmers, dtype=np.uint64)
        vidx = np.asarray(vidx, dtype=np.int32)
        _, idx = np.unique(kmers, return_index=True)
        # always reorder: kmers[idx] is sorted, and vidx must ride along even
        # when the chunk is duplicate-free (an unsorted duplicate-free chunk
        # previously desynced keys from values in build())
        self._kmer_chunks.append(kmers[idx])
        self._vidx_chunks.append(vidx[idx])

    def pending_kmers(self) -> int:
        return sum(len(c) for c in self._kmer_chunks)

    def build(self) -> "KmerTable":
        """Finalize: sorted unique keys, first-inserted value wins per k-mer
        (as in the reference's fill-filter dedup, ref KMerSortedArray
        putLong:168-202).

        Avoids the big stable argsort (measured ~6x the cost of a value
        sort): unique keys come from one value sort-dedup; values are then
        assigned chunk by chunk in feed order into the unassigned slots.
        Chunks from add() carry one uniform value; add_pairs chunks are
        stored sorted-by-k-mer with aligned values — either way the aligned
        scatter below is order-safe."""
        if not self._kmer_chunks:
            return KmerTable(self.k, np.zeros(0, np.uint64),
                             np.zeros(0, np.int32), list(self.values))
        keys = np.unique(np.concatenate(self._kmer_chunks)
                         if len(self._kmer_chunks) > 1 else self._kmer_chunks[0])
        vidx = np.full(len(keys), -1, np.int32)
        for ck, cv in zip(self._kmer_chunks, self._vidx_chunks):
            # argsort keeps keys and values aligned for ANY chunk ordering
            # (add() chunks are unsorted-with-uniform-value; add_pairs chunks
            # arrive pre-sorted, making this a near-no-op there)
            o = np.argsort(ck)
            pos = np.searchsorted(keys, ck[o])
            un = vidx[pos] == -1
            vidx[pos[un]] = cv[o][un]
        return KmerTable(self.k, keys, vidx, list(self.values))


@dataclass
class KmerTable:
    """Sorted, deduplicated k-mer table with per-entry value indexes."""

    k: int
    keys: np.ndarray        # uint64 [N], sorted ascending
    value_idx: np.ndarray   # int32 [N]
    values: list[str]       # value index -> taxid string
    value_map: dict[str, int] = field(default_factory=dict)

    def __post_init__(self):
        if not self.value_map:
            self.value_map = {v: i for i, v in enumerate(self.values)}

    # -- value <-> index ----------------------------------------------------

    @property
    def n_values(self) -> int:
        return len(self.values)

    @property
    def entries(self) -> int:
        return len(self.keys)

    def get_add_value_index(self, value: str) -> int:
        """Register a value if new; mirrors AbstractKMerStore.getAddValueIndex."""
        idx = self.value_map.get(value)
        if idx is None:
            if len(self.values) >= MAX_VALUES:
                raise ValueError(f"Too many different values - only {MAX_VALUES} are possible.")
            idx = len(self.values)
            self.value_map[value] = idx
            self.values.append(value)
        return idx

    def get_index_for_value(self, value: str) -> int:
        return self.value_map.get(value, -1)

    # -- host lookup ---------------------------------------------------------

    def find_np(self, kmers: np.ndarray) -> np.ndarray:
        """Positions of the given k-mers in the table, -1 where absent."""
        kmers = np.asarray(kmers, dtype=np.uint64)
        pos = np.searchsorted(self.keys, kmers)
        pos_c = np.minimum(pos, max(len(self.keys) - 1, 0))
        found = (len(self.keys) > 0) & (self.keys[pos_c] == kmers)
        return np.where(found, pos_c, -1).astype(np.int64)

    def get_np(self, kmers: np.ndarray):
        """(value_idx int32 [Q] with -1 for miss, pos int64 [Q])."""
        pos = self.find_np(kmers)
        vi = np.where(pos >= 0, self.value_idx[np.maximum(pos, 0)].astype(np.int32), -1)
        return vi, pos

    # -- update (LCA phase) --------------------------------------------------

    def set_value_idx_at(self, pos: np.ndarray, vidx: np.ndarray) -> None:
        self.value_idx[pos] = vidx.astype(np.int32)

    # -- stats ---------------------------------------------------------------

    def n_kmers_per_value(self) -> np.ndarray:
        """Stored k-mer count per value index (ref: AbstractKMerStore.getNKmersPerTaxid)."""
        return np.bincount(self.value_idx, minlength=self.n_values).astype(np.int64)

    # -- persistence ---------------------------------------------------------

    def save_npz(self, path) -> None:
        if not hasattr(path, "write"):
            # open explicitly: np.savez appends '.npz' to plain string paths
            with open(path, "wb") as fh:
                self.save_npz(fh)
            return
        np.savez_compressed(
            path,
            k=np.int64(self.k),
            keys=self.keys,
            value_idx=self.value_idx,
            values=np.array(json.dumps(self.values)),
        )

    @staticmethod
    def load_npz(path) -> "KmerTable":
        with np.load(path, allow_pickle=False) as z:
            return KmerTable(
                int(z["k"]),
                z["keys"],
                z["value_idx"],
                json.loads(str(z["values"])),
            )

