"""CSV report writers — bit-exact layout parity with the reference.

Reference equivalent: core match/ResultReporter.java. The reference drives
columns reflectively off @MDCDescription annotations on CountsPerTaxid
getters; here the column table is written out explicitly in the same sorted
order (see CSVColumns.md in the reference repo for the documented list).
Separator is ';', doubles print via Java Double.toString semantics
(java_format.java_double_str).
"""

from __future__ import annotations

import math

from genestrip_tpu_torch.match.results import VALUE_TYPES, CountsPerTaxid, MatchingResult, div
from genestrip_tpu_torch.report.java_format import decimal_format_8, java_double_str


def _d(v: float, pos: int, always: bool = False) -> str:
    """A double column: suppressed when NaN/Infinite or on the global row
    (ref: ResultReporter.java:249-252), except 'avg. read length' (pos==13)."""
    if math.isnan(v) or math.isinf(v) or (pos == 0 and not always):
        return ""
    return java_double_str(v)


def match_report_lines(res: MatchingResult):
    """Yield the match CSV lines (without trailing newline), header first.

    ref: ResultReporter.printMatchResult:190-279.
    """
    header = ["pos", "level", "name", "rank", "taxid", "reads", "kmers from reads",
              "kmers", "unique kmers", "contigs", "average contig length",
              "max contig length", "reads >=1 kmer", "reads bps", "avg. read length",
              "db coverage", "exp. unique kmers", "unique kmers / exp.", "db kmers",
              "parent taxid", "mean error", "kmer error std. dev.", "mean class error",
              "class error std. dev.", "contig len std. dev."]
    for vt in VALUE_TYPES:
        header.append(f"norm. {vt}")
    for vt in VALUE_TYPES:
        header.append(f"acc. {vt}")
        header.append(f"acc. norm. {vt}")
    header += ["max contig desc.", "acc. mean error", "acc. error std. dev.",
               "acc. mean class error", "acc. class error std. dev."]
    if res.with_max_kmer_counts:
        header.append("max kmer counts")
    yield ";".join(header) + ";"

    for s in res.sorted_stats():
        p = s.pos
        row = [
            str(p),
            str(s.level),
            s.name or "",
            s.rank or "",
            s.taxid or "",
            str(s.reads),
            str(s.reads_kmers),
            str(s.kmers),
            str(s.unique_kmers),
            str(s.contigs),
            _d(s.average_contig_len(), p),
            str(s.max_contig_len),
            str(s.reads1_kmer),
            str(s.reads_bps),
            _d(s.average_read_length(), p, always=True),
            _d(s.coverage(), p),
            _d(s.expected_unique_kmers(), p),
            _d(s.kmer_consistency(), p),
            str(s.db_kmers),
            s.parent_taxid if s.parent_taxid is not None else "",
            _d(s.mean_error(), p),
            _d(s.error_std_dev(), p),
            _d(s.mean_class_error(), p),
            _d(s.class_error_std_dev(), p),
            _d(s.contig_len_std_dev(), p),
        ]
        for vt in VALUE_TYPES:
            row.append(_d(div(s.value_for(vt), s.db_kmers), p))
        for vt in VALUE_TYPES:
            acc = s.acc.get(vt)
            if acc is None:
                row.append("")
                row.append("")
            else:
                row.append(str(acc[0]))
                row.append(java_double_str(acc[1]))
        desc = s.max_contig_descriptor
        z = desc.find(b"\x00")
        row.append((desc[:z] if z >= 0 else desc).decode("latin-1"))
        row.append(_d(s.acc_mean_error(), p))
        row.append(_d(s.acc_error_std_dev(), p))
        row.append(_d(s.acc_mean_class_error(), p))
        row.append(_d(s.acc_class_error_std_dev(), p))
        if res.with_max_kmer_counts:
            mc = s.max_kmer_counts
            row.append(";".join(str(int(c)) for c in mc) if mc is not None else "")
        yield ";".join(row) + ";"


def write_match_report(res: MatchingResult, path) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for line in match_report_lines(res):
            f.write(line + "\n")


# ---------------------------------------------------------------------------
# dbinfo CSV (ref: ResultReporter.printStoreInfo:65-107)
# ---------------------------------------------------------------------------

def compute_distances(tree, db_stats: dict, k: int):
    """Evolutionary distances per node (ref: match/EvoDistanceEstimator.java).

    distance(n) = 1 - (1 - below/sum)^(1/k) with below = k-mers on the
    heaviest descending path incl. n, and sum = below + k-mers on the path
    above n. Portion = distance(n) - distance(strongest child branch).
    """
    n = len(tree)
    below_best = [0] * n          # heaviest descending path starting at node
    branch = [-1] * n
    own = [db_stats.get(tree.taxids[i], 0) for i in range(n)]
    # children lists from parent array
    children: list[list[int]] = [[] for _ in range(n)]
    for i in range(1, n):
        children[int(tree.parent[i])].append(i)
    for i in range(n - 1, -1, -1):
        child_max = 0
        b = -1
        for c in children[i]:
            if below_best[c] > child_max:
                child_max = below_best[c]
                b = c
        below_best[i] = child_max + own[i]
        branch[i] = b
    dist = [0.0] * n
    for i in range(n):
        above = 0
        p = int(tree.parent[i])
        while p >= 0:
            above += own[p]
            p = int(tree.parent[p])
        total = above + below_best[i]
        ratio = div(below_best[i], total)
        try:
            dist[i] = 1 - math.pow(1 - ratio, 1.0 / k)
        except (ValueError, OverflowError):
            dist[i] = float("nan")
        if ratio != ratio:
            dist[i] = float("nan")
    portion = [dist[i] - (dist[branch[i]] if branch[i] >= 0 else 0) for i in range(n)]
    return dist, portion, branch


def dbinfo_lines(tree, db_stats: dict, k: int, total_entries: int, md5: str | None):
    """Yield dbinfo CSV lines (ref: printStoreInfo — note the literal spaces
    in the total row)."""
    yield "pos;level;name;rank;taxid;stored kmers;requested;distance;distance portion;"
    yield f"0;0;TOTAL;no rank;{md5 or ''};{total_entries}; false; 0; 0;"
    dist, portion, _branch = compute_distances(tree, db_stats, k)
    for i in range(len(tree)):
        yield (f"{i + 1};{int(tree.depth[i])};{tree.names[i]};{tree.rank_name(i) or 'null'};"
               f"{tree.taxids[i]};{db_stats.get(tree.taxids[i], 0)};"
               f"{'true' if tree.requested[i] else 'false'};"
               f"{decimal_format_8(dist[i])};{decimal_format_8(portion[i])};")


def write_dbinfo(tree, db_stats: dict, k: int, total_entries: int, md5: str | None, path) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for line in dbinfo_lines(tree, db_stats, k, total_entries, md5):
            f.write(line + "\n")
