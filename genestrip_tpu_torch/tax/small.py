"""Flattened compact taxonomy for matching — the device-facing tax tree.

Reference equivalent: core tax/SmallTaxTree.java (compact serializable tree
holding only required nodes, per-read vote counters, path sums, LCA). The
TPU redesign flattens the tree into arrays indexed by pre-order position:

  parent[i], depth[i], tin[i]/tout[i] (Euler intervals for O(1) ancestor
  tests), ancestor_at_depth[i, d] (for vectorized LCA), requested[i],
  store_index[i].

Per-read vote counters do NOT live here: votes are dense [batch, n_nodes]
arrays produced by the matcher's segment ops (ref: SmallTaxTree.incCount's
per-thread epoch counters become a scatter-add, see match/pipeline.py).
"""

from __future__ import annotations

import json

import numpy as np

from genestrip_tpu_torch.tax.tree import Rank, TaxNode, TaxTree


class SmallTaxTree:
    """Array-of-structs compact taxonomy, nodes in pre-order."""

    def __init__(self, taxids, names, rank_ordinals, parent, requested):
        n = len(taxids)
        self.taxids: list[str] = list(taxids)
        self.names: list[str] = list(names)
        self.rank_ordinals = np.asarray(rank_ordinals, dtype=np.int16)
        self.parent = np.asarray(parent, dtype=np.int32)        # -1 for root
        self.requested = np.asarray(requested, dtype=bool)
        self.by_taxid = {t: i for i, t in enumerate(self.taxids)}
        self.store_index = np.full(n, -1, dtype=np.int32)

        # depth
        self.depth = np.zeros(n, dtype=np.int32)
        for i in range(1, n):
            self.depth[i] = self.depth[self.parent[i]] + 1
        self.max_depth = int(self.depth.max(initial=0))

        # Euler intervals: nodes are in pre-order, so tin = index and
        # tout = index after the whole subtree; computed via subtree sizes.
        self.tin = np.arange(n, dtype=np.int32)
        sizes = np.ones(n, dtype=np.int64)
        for i in range(n - 1, 0, -1):
            sizes[self.parent[i]] += sizes[i]
        self.tout = (self.tin + sizes).astype(np.int32)

        # ancestor_at_depth[i, d]: ancestor of i at depth d, or -1 if d > depth(i)
        md = self.max_depth + 1
        anc = np.full((n, md), -1, dtype=np.int32)
        for i in range(n):
            anc[i, self.depth[i]] = i
            p = self.parent[i]
            if p >= 0:
                anc[i, : self.depth[i]] = anc[p, : self.depth[i]]
        self.ancestor_at_depth = anc

    # -- construction --------------------------------------------------------

    @staticmethod
    def from_tax_tree(tree: TaxTree) -> "SmallTaxTree":
        """Retain required nodes only, preserving child order (ref: SmallTaxTree ctor)."""
        taxids, names, ranks, parent, requested = [], [], [], [], []

        def visit(node: TaxNode, parent_idx: int):
            idx = len(taxids)
            taxids.append(node.tax_id)
            names.append(node.name or "")
            ranks.append(node.rank_ordinal)
            parent.append(parent_idx)
            requested.append(node.requested)
            for child in node.children:
                if child.required:
                    visit(child, idx)

        if tree.root is not None and tree.root.required:
            visit(tree.root, -1)
        return SmallTaxTree(taxids, names, ranks, parent, requested)

    # -- basic accessors -----------------------------------------------------

    def __len__(self):
        return len(self.taxids)

    def get(self, taxid: str) -> int:
        """Node index for a taxid, or -1."""
        return self.by_taxid.get(taxid, -1)

    def rank_name(self, i: int) -> str:
        r = Rank.by_ordinal(int(self.rank_ordinals[i]))
        return "" if r is None else r.name

    # -- queries (host) ------------------------------------------------------

    def is_ancestor_of(self, node: int, ancestor: int) -> bool:
        """Whether `ancestor` is on the path node->root (ancestor-or-equal).

        ref: SmallTaxTree.isAncestorOf:242-252 — here O(1) via Euler intervals.
        """
        return bool(self.tin[ancestor] <= self.tin[node] < self.tout[ancestor])

    def lca(self, a: int, b: int) -> int:
        """Lowest common ancestor (ref: SmallTaxTree.getLowestCommonAncestor:263-289)."""
        if a == b:
            return a
        if a < 0 or b < 0:
            return -1
        anc_a = self.ancestor_at_depth[a]
        anc_b = self.ancestor_at_depth[b]
        match = (anc_a == anc_b) & (anc_a >= 0)
        # matches form a prefix along the depth axis
        d = int(match.sum()) - 1
        return int(anc_a[d]) if d >= 0 else -1

    def lca_np(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Vectorized LCA over index arrays; -1 entries propagate to -1."""
        a = np.asarray(a, dtype=np.int64)
        b = np.asarray(b, dtype=np.int64)
        anc_a = self.ancestor_at_depth[np.maximum(a, 0)]
        anc_b = self.ancestor_at_depth[np.maximum(b, 0)]
        match = (anc_a == anc_b) & (anc_a >= 0)
        d = match.sum(axis=-1) - 1
        res = np.where(d >= 0, anc_a[np.arange(len(a)), np.maximum(d, 0)], -1)
        return np.where((a < 0) | (b < 0), -1, res).astype(np.int32)

    def sort_taxids(self, taxids: list) -> list:
        """Sort taxid strings in tree (pre-order) order; unknown ids sort
        lexicographically; None sorts first (ref: SmallTaxTree.sortTaxidsViaTree).
        """
        def key(t):
            if t is None:
                return (0, 0, "")
            i = self.by_taxid.get(t)
            if i is None:
                return (0, 0, t)
            return (1, i, "")
        return sorted(taxids, key=key)

    # -- store index wiring (ref: store/Database.initStoreIndices) -----------

    def init_store_indices(self, table) -> None:
        """Assign each node its table value index in pre-order, adding missing ones."""
        for i in range(len(self.taxids)):
            self.store_index[i] = table.get_add_value_index(self.taxids[i])

    def node_of_value(self, table) -> np.ndarray:
        """Map table value index -> tree node index (-1 if the value's taxid
        is not a tree node)."""
        out = np.full(table.n_values, -1, dtype=np.int32)
        for vi, taxid in enumerate(table.values):
            out[vi] = self.by_taxid.get(taxid, -1)
        return out

    # -- persistence ---------------------------------------------------------

    def to_json(self) -> str:
        return json.dumps({
            "taxids": self.taxids,
            "names": self.names,
            "ranks": self.rank_ordinals.tolist(),
            "parent": self.parent.tolist(),
            "requested": self.requested.astype(int).tolist(),
        })

    @staticmethod
    def from_json(s: str) -> "SmallTaxTree":
        d = json.loads(s)
        return SmallTaxTree(d["taxids"], d["names"], d["ranks"], d["parent"],
                            np.asarray(d["requested"], dtype=bool))
