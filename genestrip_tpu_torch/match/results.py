"""Per-tax-id match statistics and result finalization.

Reference equivalents: core match/CountsPerTaxid.java (the ~45-column stat
accumulator) and match/MatchingResult.java (ancestor fill, tree-order sort,
subtree accumulation).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from genestrip_tpu_torch.tax.small import SmallTaxTree

# Value types in reference order (ref: CountsPerTaxid.ValueType)
VALUE_TYPES = ["reads", "kmers", "reads bps", "read >=1 kmer", "reads kmers"]


@dataclass
class CountsPerTaxid:
    level: int
    taxid: str | None
    reads: int = 0
    reads1_kmer: int = 0
    reads_bps: int = 0
    reads_kmers: int = 0
    unique_kmers: int = 0
    kmers: int = 0
    contigs: int = 0
    contig_len_squared_sum: int = 0
    max_contig_len: int = 0
    max_contig_descriptor: bytes = b""
    max_kmer_counts: list | None = None
    error_sum: float = 0.0
    error_squared_sum: float = 0.0
    class_error_sum: float = 0.0
    class_error_squared_sum: float = 0.0

    # completed fields
    pos: int = 0
    name: str | None = None
    rank: str | None = None
    db_kmers: int = 0
    parent_taxid: str | None = None
    acc: dict = field(default_factory=dict)          # value type -> [acc, acc_norm]
    acc_error_sum: float = 0.0
    acc_error_squared_sum: float = 0.0
    acc_class_error_sum: float = 0.0
    acc_class_error_squared_sum: float = 0.0

    def value_for(self, vt: str) -> int:
        return {
            "reads": self.reads,
            "kmers": self.kmers,
            "reads bps": self.reads_bps,
            "read >=1 kmer": self.reads1_kmer,
            "reads kmers": self.reads_kmers,
        }[vt]

    # -- derived columns (ref: CountsPerTaxid getters) ----------------------

    def average_contig_len(self):
        return div(self.kmers, self.contigs)

    def average_read_length(self):
        return div(self.reads_bps, self.reads)

    def coverage(self):
        return div(self.unique_kmers, self.db_kmers)

    def expected_unique_kmers(self):
        if self.db_kmers == 0:
            # 1 - (1 - 1/0)^kmers -> (1 - inf^...) follows Java semantics:
            # 1/0 = inf, (1-inf) = -inf, (-inf)^kmers = +-inf, 1-that = -+inf
            base = float("-inf")
            p = pow_java(base, self.kmers)
            return (1 - p) * self.db_kmers  # 0 * inf = nan in Java too
        return (1 - (1 - 1.0 / self.db_kmers) ** self.kmers) * self.db_kmers

    def kmer_consistency(self):
        return div(self.unique_kmers, self.expected_unique_kmers())

    def mean_error(self):
        return div(self.error_sum, self.reads)

    def error_std_dev(self):
        return std_dev(self.error_squared_sum, self.error_sum, self.reads)

    def mean_class_error(self):
        return div(self.class_error_sum, self.reads)

    def class_error_std_dev(self):
        return std_dev(self.class_error_squared_sum, self.class_error_sum, self.reads)

    def contig_len_std_dev(self):
        # ref: sqrt((contigLenSquaredSum - kmers^2/contigs) / (contigs - 1))
        if self.contigs == 0:
            return float("nan")
        v = (self.contig_len_squared_sum - (self.kmers * self.kmers) / self.contigs)
        return sqrt_java(div(v, self.contigs - 1))

    def acc_mean_error(self):
        r = self.acc.get("reads", [0, 0.0])[0]
        return div(self.acc_error_sum, r)

    def acc_error_std_dev(self):
        r = self.acc.get("reads", [0, 0.0])[0]
        return std_dev(self.acc_error_squared_sum, self.acc_error_sum, r)

    def acc_mean_class_error(self):
        r = self.acc.get("reads", [0, 0.0])[0]
        return div(self.acc_class_error_sum, r)

    def acc_class_error_std_dev(self):
        r = self.acc.get("reads", [0, 0.0])[0]
        return std_dev(self.acc_class_error_squared_sum, self.acc_class_error_sum, r)


def div(a, b) -> float:
    """Java double division semantics (x/0 = inf/nan, not an exception)."""
    a = float(a)
    b = float(b)
    if b == 0.0:
        if a == 0.0 or a != a:
            return float("nan")
        return float("inf") if a > 0 else float("-inf")
    return a / b


def sqrt_java(x: float) -> float:
    return float("nan") if (x != x or x < 0) else math.sqrt(x)


def pow_java(base: float, exp: float) -> float:
    try:
        return math.pow(base, exp)
    except (ValueError, OverflowError):
        return float("nan")


def std_dev(sq_sum: float, s: float, n) -> float:
    """ref: sqrt((sqSum - s*s/n) / (n - 1)) with Java double semantics."""
    return sqrt_java(div(sq_sum - div_raw(s * s, n), n - 1))


def div_raw(a, b) -> float:
    return div(a, b)


class MatchingResult:
    """ref: match/MatchingResult.java."""

    def __init__(self, k: int, taxid2stats: dict[str, CountsPerTaxid], db_md5: str,
                 total_reads: int, total_kmers: int, total_bps: int,
                 total_max_counts=None):
        self.k = k
        self.taxid2stats = taxid2stats
        # The global row: reads/kmers/readsBPs are totals; its
        # maxContigDescriptor carries the database MD5 (ref:
        # FastqKMerMatcher.java:233 passing dbMD5 as totalDesc).
        g = CountsPerTaxid(0, None)
        g.reads = total_reads
        g.kmers = total_kmers
        g.reads_bps = total_bps
        g.max_contig_descriptor = (db_md5 or "").encode()
        g.max_kmer_counts = total_max_counts
        self.global_stats = g

    @property
    def with_max_kmer_counts(self) -> bool:
        return self.global_stats.max_kmer_counts is not None

    def complete_results(self, tree: SmallTaxTree, db_stats: dict[str | None, int]) -> None:
        """Ancestor fill + tree-order position + accumulation
        (ref: MatchingResult.completeResults:84-118)."""
        self.taxid2stats[None] = self.global_stats
        # add missing ancestors
        for key in list(self.taxid2stats.keys()):
            if key is None:
                continue
            i = tree.get(key)
            if i < 0:
                continue
            p = int(tree.parent[i])
            while p >= 0:
                t = tree.taxids[p]
                if t not in self.taxid2stats:
                    self.taxid2stats[t] = CountsPerTaxid(int(tree.depth[p]), t)
                p = int(tree.parent[p])
        keys = tree.sort_taxids(list(self.taxid2stats.keys()))
        for pos, key in enumerate(keys):
            stats = self.taxid2stats[key]
            db_kmers = db_stats.get(key, 0)
            i = -1 if key is None else tree.get(key)
            stats.pos = pos
            stats.db_kmers = db_kmers
            if i >= 0:
                stats.name = tree.names[i]
                stats.rank = tree.rank_name(i)
                pi = int(tree.parent[i])
                stats.parent_taxid = tree.taxids[pi] if pi >= 0 else ""
                for vt in VALUE_TYPES:
                    v = stats.value_for(vt)
                    stats.acc[vt] = [v, div0(v, db_kmers)]
                stats.acc_error_sum = stats.error_sum
                stats.acc_error_squared_sum = stats.error_squared_sum
                stats.acc_class_error_sum = stats.class_error_sum
                stats.acc_class_error_squared_sum = stats.class_error_squared_sum
                # accumulate into all ancestors (processed keys are in
                # pre-order so ancestors were already completed)
                p = int(tree.parent[i])
                while p >= 0:
                    s2 = self.taxid2stats.get(tree.taxids[p])
                    if s2 is not None:
                        for vt in VALUE_TYPES:
                            if vt in s2.acc:
                                s2.acc[vt][0] += stats.acc[vt][0]
                                s2.acc[vt][1] += stats.acc[vt][1]
                        s2.acc_error_sum += stats.acc_error_sum
                        s2.acc_error_squared_sum += stats.acc_error_squared_sum
                        s2.acc_class_error_sum += stats.acc_class_error_sum
                        s2.acc_class_error_squared_sum += stats.acc_class_error_squared_sum
                    p = int(tree.parent[p])
            else:
                stats.name = "TOTAL"

    def sorted_stats(self) -> list[CountsPerTaxid]:
        return sorted(self.taxid2stats.values(), key=lambda s: s.pos)


def div0(v, db_kmers) -> float:
    """ref: AccValues ctor — normalized is 0 when dbKMers <= 0."""
    return (float(v) / db_kmers) if db_kmers > 0 else 0.0
