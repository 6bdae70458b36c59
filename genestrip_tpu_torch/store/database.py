"""The database container: k-mer table + compact taxonomy + provenance.

Reference equivalent: core store/Database.java — a zip of the serialized
store, its bloom pre-filter and a configInfo.properties entry carrying an
MD5 fingerprint of the database payload (ref: Database.save:201-237). The
TPU format replaces Java serialization with npz (table) + JSON (taxonomy);
there is no bloom pre-filter entry (lookups are batched binary search, and
a Pallas bloom stage, if added, is derived data). The MD5 is computed over
the table + taxonomy payloads and stamped into configInfo under the same
"dbMD5" key so result CSVs carry the same provenance field.
"""

from __future__ import annotations

import hashlib
import io
import zipfile

import numpy as np

from genestrip_tpu_torch.store.table import KmerTable
from genestrip_tpu_torch.tax.small import SmallTaxTree

TABLE_FILE = "table.npz"
TAXTREE_FILE = "taxtree.json"
HASH_FILE = "hash.npz"
CONFIG_INFO_FILE = "configInfo.properties"

DB_MD5 = "dbMD5"


class Database:
    def __init__(self, table: KmerTable, tree: SmallTaxTree, config_info: dict | None = None):
        self.table = table
        self.tree = tree
        self.config_info = dict(config_info or {})
        # Optional persisted quotient-hash (derived data; see save()) — the
        # matcher uses it to skip the hash build at load time. The reference
        # likewise serializes its store's internal layout + pre-filter
        # directly (ref: store/Database.java:201-250 db.ser/bloom.ser).
        # Loaded LAZILY from _hash_path: goals that never look k-mers up
        # (dbinfo, svgtaxtree, showdbconf, ...) skip the ~400 MB read.
        self._prebuilt_hash = None
        self._hash_path = None

    @property
    def prebuilt_hash(self):
        if self._prebuilt_hash is None and self._hash_path is not None:
            path, self._hash_path = self._hash_path, None
            self._prebuilt_hash = _read_hash_entry(
                path, self.config_info.get(DB_MD5))
        return self._prebuilt_hash

    @prebuilt_hash.setter
    def prebuilt_hash(self, ht):
        self._prebuilt_hash = ht
        self._hash_path = None

    def init_store_indices(self) -> None:
        """ref: Database.initStoreIndices — pre-order value-index assignment."""
        self.tree.init_store_indices(self.table)

    def stats(self) -> dict:
        """Per-taxid stored k-mer counts; None key = total entries
        (ref: AbstractKMerStore.getNKmersPerTaxid:338-356)."""
        counts = self.table.n_kmers_per_value()
        out = {self.table.values[i]: int(counts[i]) for i in range(len(counts))}
        out[None] = self.table.entries
        return out

    @property
    def md5(self) -> str | None:
        return self.config_info.get(DB_MD5)

    @property
    def k(self) -> int:
        return self.table.k

    # -- persistence ---------------------------------------------------------

    def save(self, path, include_hash: bool = False) -> None:
        """Write the zip. With include_hash, the derived quotient-hash
        (store/hash.py) is persisted as an extra STORED entry so match runs
        skip the hash build at load time — used for the final db, not the
        tempdb (whose values the update phase still rewrites). The MD5 covers
        only table + taxonomy (the hash is derived data), so hash presence
        does not change database identity."""
        buf = io.BytesIO()
        self.table.save_npz(buf)
        table_bytes = buf.getvalue()
        tree_bytes = self.tree.to_json().encode()
        digest = hashlib.md5()
        digest.update(table_bytes)
        digest.update(tree_bytes)
        self.config_info[DB_MD5] = digest.hexdigest()
        with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_DEFLATED) as z:
            z.writestr(TABLE_FILE, table_bytes)
            z.writestr(TAXTREE_FILE, tree_bytes)
            z.writestr(CONFIG_INFO_FILE, _props_bytes(self.config_info))
            if include_hash:
                ht = self.prebuilt_hash
                # reuse an existing hash ONLY when its stamp matches the
                # table being written: a hash loaded from disk and carried
                # across a table mutation would otherwise be re-stamped
                # with the new MD5, defeating the staleness guard
                if (ht is None or getattr(ht, "db_md5_stamp", None)
                        != self.config_info[DB_MD5]):
                    from genestrip_tpu_torch.store.hash import build_hash
                    ht = build_hash(self.table.keys, self.table.value_idx)
                    ht.db_md5_stamp = self.config_info[DB_MD5]
                    self.prebuilt_hash = ht
                hbuf = io.BytesIO()
                np.savez(hbuf, rows=ht.rows,
                         nb_bits=np.int64(ht.nb_bits),
                         slot_of_entry=ht.slot_of_entry.astype(np.int64),
                         # identity stamp: load ignores a hash whose table
                         # no longer matches (derived-data safety)
                         db_md5=np.array(self.config_info[DB_MD5]))
                # STORED: the packed rows are high-entropy; deflate would
                # cost tens of seconds for a few % size
                z.writestr(zipfile.ZipInfo(HASH_FILE), hbuf.getvalue(),
                           compress_type=zipfile.ZIP_STORED)

    @staticmethod
    def load(path) -> "Database":
        with zipfile.ZipFile(path, "r") as z:
            table = KmerTable.load_npz(io.BytesIO(z.read(TABLE_FILE)))
            tree = SmallTaxTree.from_json(z.read(TAXTREE_FILE).decode())
            config_info = _parse_props(z.read(CONFIG_INFO_FILE).decode())
            has_hash = HASH_FILE in z.namelist()
        db = Database(table, tree, config_info)
        if has_hash:
            db._hash_path = path          # parsed lazily on first use
        db.init_store_indices()
        return db

    @staticmethod
    def load_config_info(path) -> dict:
        with zipfile.ZipFile(path, "r") as z:
            return _parse_props(z.read(CONFIG_INFO_FILE).decode())


def _read_hash_entry(path, want_md5):
    """Parse HASH_FILE from a db zip; None when absent or when the stamp
    mismatches `want_md5` (stale derived data — table edited without a
    re-save; the caller then rebuilds the hash at use)."""
    from genestrip_tpu_torch.store.hash import (
        KmerHashTable, vidx_of_slot_from_rows)
    with zipfile.ZipFile(path, "r") as z:
        if HASH_FILE not in z.namelist():
            return None
        with np.load(io.BytesIO(z.read(HASH_FILE))) as h:
            stamp = str(h["db_md5"]) if "db_md5" in h else None
            if stamp != want_md5:
                return None
            rows = h["rows"]
            nb_bits = int(h["nb_bits"])
            soe = h["slot_of_entry"]
    ht = KmerHashTable(rows, nb_bits, soe,
                       vidx_of_slot_from_rows(rows, nb_bits))
    ht.db_md5_stamp = stamp
    return ht


def _props_bytes(props: dict) -> bytes:
    lines = ["# Genestrip-TPU database configuration information"]
    for k in sorted(props):
        lines.append(f"{k}={props[k]}")
    return ("\n".join(lines) + "\n").encode()


def _parse_props(text: str) -> dict:
    out = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        k, _, v = line.partition("=")
        out[k.strip()] = v.strip()
    return out
