"""NCBI taxonomy tree: parsing, ranks, node selection.

Reference equivalents: core tax/TaxTree.java (nodes.dmp/names.dmp parsing,
parent/children/rank, artificial DATA/FILE/ID nodes, pre-order positions),
tax/Rank.java (rank lattice incl. synthetic ranks), tax/TaxIdCollector.java
(taxids.txt with '-' excludes and '#' comments, descendant completion).
"""

from __future__ import annotations

import gzip
from pathlib import Path

# ---------------------------------------------------------------------------
# Ranks (ref: core tax/Rank.java — names, ordinal encoding, level ordering)
# ---------------------------------------------------------------------------

_RANK_DEFS = [
    # (name, level or None -> ordinal*20)
    ("cellular root", None), ("acellular root", None), ("superkingdom", None),
    ("domain", None), ("realm", None), ("kingdom", None), ("phylum", None),
    ("subphylum", None), ("superclass", None), ("class", None), ("subclass", None),
    ("superorder", None), ("order", None), ("suborder", None), ("superfamily", None),
    ("family", None), ("subfamily", None), ("tribe", None), ("genus", None),
    ("subgenus", None), ("species group", None), ("species", None), ("varietas", None),
    ("subspecies", None), ("serogroup", None), ("biotype", None), ("strain", None),
    ("serotype", None), ("genotype", None), ("forma", None), ("forma specialis", None),
    ("isolate", None), ("clade", -1), ("no rank", -1),
    ("subkingdom", 5 * 20 + 10),   # just below kingdom (ordinal 5)
    ("section", 18 * 20 + 10),     # just below genus (ordinal 18)
    ("REFINED", None), ("DATA", None), ("FILE", None), ("ID", None),
]

INDETERMINATE_LEVEL = -1


class Rank:
    """A taxonomic rank with a stable ordinal and an order level."""

    _all: list["Rank"] = []
    _by_name: dict[str, "Rank"] = {}

    def __init__(self, ordinal: int, name: str, level: int):
        self.ordinal = ordinal
        self.name = name
        self.level = level

    def __repr__(self):
        return f"Rank({self.name})"

    def __str__(self):
        return self.name

    @property
    def indeterminate(self) -> bool:
        return self.level == INDETERMINATE_LEVEL

    def is_comparable_to(self, other) -> bool:
        return not self.indeterminate and other is not None and not other.indeterminate

    def is_below(self, other) -> bool:
        return self.is_comparable_to(other) and self.level > other.level

    def is_above(self, other) -> bool:
        return self.is_comparable_to(other) and self.level < other.level

    @staticmethod
    def by_name(name: str) -> "Rank | None":
        return Rank._by_name.get(name)

    @staticmethod
    def by_ordinal(i: int) -> "Rank | None":
        return None if i < 0 else Rank._all[i]

    @staticmethod
    def values() -> list["Rank"]:
        return Rank._all


for _i, (_n, _lvl) in enumerate(_RANK_DEFS):
    _r = Rank(_i, _n, _i * 20 if _lvl is None else _lvl)
    Rank._all.append(_r)
    Rank._by_name[_n] = _r

RANK_REFINED = Rank.by_name("REFINED")
RANK_DATA = Rank.by_name("DATA")
RANK_FILE = Rank.by_name("FILE")
RANK_ID = Rank.by_name("ID")
RANK_NO_RANK = Rank.by_name("no rank")


# ---------------------------------------------------------------------------
# Tree
# ---------------------------------------------------------------------------

class TaxNode:
    __slots__ = ("tax_id", "name", "rank_ordinal", "parent", "children", "position",
                 "depth", "required", "requested", "store_index", "ref_seq_regions")

    def __init__(self, tax_id: str):
        self.tax_id = tax_id
        self.name: str | None = None
        self.rank_ordinal: int = -1
        self.parent: TaxNode | None = None
        self.children: list[TaxNode] = []
        self.position = 0
        self.depth = 0
        self.required = False
        self.requested = False
        self.store_index = -1
        self.ref_seq_regions = 0

    @property
    def rank(self) -> Rank | None:
        return Rank.by_ordinal(self.rank_ordinal)

    def mark_required(self):
        """Mark this node and its ancestors as required (ref: TaxTree.TaxIdNode.markRequired)."""
        node = self
        while node is not None and not node.required:
            node.required = True
            node = node.parent

    def inc_refseq_regions(self):
        node = self
        while node is not None:
            node.ref_seq_regions += 1
            node = node.parent

    def __repr__(self):
        return f"TaxNode({self.tax_id}, {self.name!r})"


def _open_text(path):
    path = str(path)
    if path.endswith(".gz") or path.endswith(".gzip"):
        return gzip.open(path, "rt", encoding="utf-8")
    return open(path, "r", encoding="utf-8")


class TaxTree:
    """The NCBI taxonomy tree parsed from nodes.dmp / names.dmp.

    Child order matches nodes.dmp line order (ref: TaxTree.addSubNode appends
    in encounter order) — this fixes the pre-order used for output sorting.
    """

    NODES_DMP = "nodes.dmp"
    NAMES_DMP = "names.dmp"

    def __init__(self, path: str | Path | None = None):
        self.by_taxid: dict[str, TaxNode] = {}
        self.root: TaxNode | None = None
        self._next_art_counter = 1
        if path is not None:
            p = Path(path)
            self.read_nodes(p / self.NODES_DMP)
            self.read_names(p / self.NAMES_DMP)
            self.init_positions()

    def _get_create(self, tax_id: str) -> TaxNode:
        node = self.by_taxid.get(tax_id)
        if node is None:
            node = TaxNode(tax_id)
            self.by_taxid[tax_id] = node
        return node

    def read_nodes(self, path) -> None:
        """Parse nodes.dmp: taxid | parent | rank | ... (ref: TaxTree.java:226-254)."""
        with _open_text(path) as f:
            for line in f:
                parts = line.split("|")
                if len(parts) < 3:
                    continue
                tax_id = parts[0].strip()
                parent_id = parts[1].strip()
                rank_name = parts[2].strip()
                node = self._get_create(tax_id)
                parent = self._get_create(parent_id)
                if node is not parent:
                    node.parent = parent
                    parent.children.append(node)
                rank = Rank.by_name(rank_name)
                node.rank_ordinal = -1 if rank is None else rank.ordinal
                if node is parent and tax_id == "1":
                    self.root = node

    def read_names(self, path) -> None:
        """Parse names.dmp, preferring scientific names (ref: TaxTree.java:196-216)."""
        with _open_text(path) as f:
            for line in f:
                parts = line.split("|")
                if len(parts) < 2:
                    continue
                node = self.by_taxid.get(parts[0].strip())
                if node is not None:
                    name = parts[1].strip("\t")
                    # The reference slices the raw field between the pipes minus
                    # the surrounding tabs; strip tabs only to preserve spaces.
                    if node.name is None or "scientific name" in line:
                        node.name = name

    def init_positions(self) -> None:
        """Assign pre-order positions and depths (ref: TaxIdNode.initPositions)."""
        if self.root is None:
            return
        # Iterative DFS preserving child order.
        counter = 0
        stack = [(self.root, 0)]
        while stack:
            node, depth = stack.pop()
            node.position = counter
            node.depth = depth
            counter += 1
            for child in reversed(node.children):
                stack.append((child, depth + 1))

    def get(self, tax_id: str) -> TaxNode | None:
        return self.by_taxid.get(tax_id)

    def is_ancestor_of(self, node: TaxNode, ancestor: TaxNode) -> bool:
        while node is not None:
            if node is ancestor:
                return True
            node = node.parent
        return False

    def lca(self, a: TaxNode | None, b: TaxNode | None) -> TaxNode | None:
        """Lowest common ancestor by depth alignment (ref: TaxTree.java:160-187)."""
        if a is b:
            return a
        if a is None or b is None:
            return None
        while a.depth > b.depth:
            a = a.parent
        while b.depth > a.depth:
            b = b.parent
        while a is not b:
            a = a.parent
            b = b.parent
        return a

    # -- artificial nodes (ref: TaxTree.dataNode/fileNode/idNode) -----------

    def _new_art_node(self, parent: TaxNode, rank: Rank, name: str) -> TaxNode:
        tax_id = "00%d" % self._next_art_counter
        self._next_art_counter += 1
        node = self._get_create(tax_id)
        node.rank_ordinal = rank.ordinal
        node.name = name
        node.parent = parent
        node.depth = parent.depth + 1
        parent.children.append(node)
        return node

    def data_node(self, node: TaxNode) -> TaxNode:
        for child in node.children:
            if child.rank_ordinal == RANK_DATA.ordinal:
                return child
        return self._new_art_node(node, RANK_DATA, "Data for " + node.tax_id)

    def file_node(self, node: TaxNode, name: str) -> TaxNode:
        for child in node.children:
            if child.name == name:
                return child
        return self._new_art_node(node, RANK_FILE, name)

    def id_node(self, node: TaxNode, name: str) -> TaxNode:
        for child in node.children:
            if child.name == name:
                return child
        return self._new_art_node(node, RANK_ID, name)


# ---------------------------------------------------------------------------
# Tax id selection (ref: core tax/TaxIdCollector.java, goals/TaxNodesGoal.java)
# ---------------------------------------------------------------------------

def read_taxids_file(tree: TaxTree, path) -> tuple[set[TaxNode], set[TaxNode]]:
    """Read taxids.txt: one id per line, '#' comments, last tab field, '-' excludes."""
    includes: set[TaxNode] = set()
    excludes: set[TaxNode] = set()
    with _open_text(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("#"):
                continue
            if "#" in line:
                line = line[:line.index("#")]
            if "\t" in line:
                line = line[line.rindex("\t"):]
            tax_id = line.strip()
            if not tax_id:
                continue
            if tax_id.startswith("-"):
                node = tree.get(tax_id[1:])
                if node is not None:
                    excludes.add(node)
            else:
                node = tree.get(tax_id)
                if node is not None:
                    includes.add(node)
    return includes, excludes


def with_descendants(nodes: set[TaxNode], depth: Rank | None = None) -> set[TaxNode]:
    """Nodes plus descendants, not descending into children below rank `depth`."""
    res: set[TaxNode] = set()

    def complete(node: TaxNode):
        res.add(node)
        for child in node.children:
            if depth is None or (child.rank is not None and not child.rank.is_below(depth)):
                complete(child)

    for node in nodes:
        complete(node)
    return res


def collect_tax_nodes(tree: TaxTree, taxids_file, completion_depth: Rank | None) -> set[TaxNode]:
    """The TaxNodesGoal semantics: includes + descendants, minus excludes + descendants."""
    includes, excludes = read_taxids_file(tree, taxids_file)
    completed = with_descendants(includes, completion_depth)
    completed -= with_descendants(excludes, None)
    return completed
