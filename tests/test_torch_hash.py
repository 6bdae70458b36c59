"""The port's quotient hash (genestrip_tpu_torch/store/hash.py) against the
JAX package's: the host build and the two-gather `lookup_hash` on the
worlds of tests/test_hash.py (the scatter-join is in test_torch_join.py);
plus the host halves of store/table.py and store/database.py, by behaviour
(a db zip moves between the packages).

Tolerance: exact equality of rows, slot ids, found flags and value indexes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from genestrip_tpu.ops.kmer import split_u64  # noqa: E402
from genestrip_tpu.store import hash as jhash  # noqa: E402
from genestrip_tpu_torch.store import hash as thash  # noqa: E402


def _world(n, seed=0, kbits=62, vmax=60000):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, 1 << kbits, n + 64, dtype=np.uint64))[:n]
    vidx = rng.integers(0, min(vmax, jhash.max_values_for(len(keys))),
                        len(keys)).astype(np.int64)
    return keys, vidx


def _random_queries(keys, seed, n_hit, n_rand):
    rng = np.random.default_rng(seed)
    q = np.concatenate([keys[rng.integers(0, len(keys), n_hit)],
                        rng.integers(0, 1 << 62, n_rand, dtype=np.uint64)])
    rng.shuffle(q)
    return q


def _worlds():
    """(name, keys, vidx, queries) for the cases of tests/test_hash.py."""
    keys, vidx = _world(60_000, seed=3)
    yield "random", keys, vidx, _random_queries(keys, 7, 30_000, 30_000)
    dense = np.arange(5_000_000, 5_100_000, dtype=np.uint64)
    # adversarial: dense key range, every query ~8x, near-collisions
    yield ("dense_duplicates", dense, (dense % 997).astype(np.int64),
           np.tile(np.arange(4_990_000, 5_010_000, dtype=np.uint64), 4))
    k15, v15 = _world(10_000, seed=5, kbits=30)
    # k = 15 keys: the hi plane is all zeros; 2-D query shape
    q15 = np.concatenate([k15[:512], np.arange(1 << 30, (1 << 30) + 512,
                                               dtype=np.uint64)])
    yield "small_k_2d", k15, v15, q15.reshape(32, 32)
    yield ("tiny", np.array([5, 77], np.uint64), np.array([1, 0], np.int64),
           np.arange(0, 4096, dtype=np.uint64).reshape(64, 64))
    yield ("empty", np.zeros(0, np.uint64), np.zeros(0, np.int64),
           np.arange(0, 64, dtype=np.uint64))


WORLDS = {w[0]: w[1:] for w in _worlds()}


def _jax(fn, ht, q, **kw):
    q_hi, q_lo = split_u64(q.reshape(-1))
    out = fn(jnp.asarray(ht.rows), jnp.asarray(q_hi.reshape(q.shape)),
             jnp.asarray(q_lo.reshape(q.shape)), nb_bits=ht.nb_bits, **kw)
    return [np.asarray(x) for x in out]


def _port(fn, ht, q, **kw):
    q_hi, q_lo = split_u64(q.reshape(-1))
    out = fn(torch.from_numpy(ht.rows),
             torch.from_numpy(q_hi.astype(np.int64).reshape(q.shape)),
             torch.from_numpy(q_lo.astype(np.int64).reshape(q.shape)),
             nb_bits=ht.nb_bits, **kw)
    return [x.numpy() for x in out]


def _assert_equal(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", list(WORLDS))
def test_build_hash_matches_jax(name):
    keys, vidx, _ = WORLDS[name]
    want = jhash.build_hash(keys, vidx)
    got = thash.build_hash(keys, vidx)
    assert got.nb_bits == want.nb_bits
    np.testing.assert_array_equal(got.rows, want.rows)
    np.testing.assert_array_equal(got.slot_of_entry, want.slot_of_entry)
    np.testing.assert_array_equal(got.vidx_of_slot, want.vidx_of_slot)


@pytest.mark.parametrize("name", list(WORLDS))
def test_lookup_hash_matches_jax(name):
    keys, vidx, q = WORLDS[name]
    ht = jhash.build_hash(keys, vidx)
    _assert_equal(_port(thash.lookup_hash, ht, q),
                  _jax(jhash.lookup_hash, ht, q))


def test_lookup_hash_bucket_range_partials():
    """Sharded-DB mode of lookup_hash: each bucket range reports exactly the
    JAX partial, and the partials cover every hit once."""
    keys, vidx = _world(20_000, seed=23)
    q = _random_queries(keys, 29, 5_000, 5_000)
    ht = jhash.build_hash(keys, vidx)
    q_hi, q_lo = split_u64(q)
    half = ht.nb // 2
    total = np.zeros(len(q), np.int64)
    for lo in (0, half):
        rows = ht.rows[lo:lo + half]
        want = jhash.lookup_hash(jnp.asarray(rows), jnp.asarray(q_hi),
                                 jnp.asarray(q_lo), nb_bits=ht.nb_bits,
                                 bucket_lo=lo)
        got = thash.lookup_hash(torch.from_numpy(rows),
                                torch.from_numpy(q_hi.astype(np.int64)),
                                torch.from_numpy(q_lo.astype(np.int64)),
                                nb_bits=ht.nb_bits, bucket_lo=lo)
        _assert_equal([x.numpy() for x in got], [np.asarray(x) for x in want])
        total += got[1].numpy()
    assert total.max() == 1 and total.sum() == np.isin(q, keys).sum()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_database_zip_moves_between_packages(tmp_path, writer):
    """A db zip written by one package loads in the other with the same
    table, taxonomy, MD5 and persisted hash."""
    from genestrip_tpu.store.database import Database as JDatabase
    from genestrip_tpu.store.table import TableBuilder as JBuilder
    from genestrip_tpu.tax.small import SmallTaxTree as JTree
    from genestrip_tpu_torch.store.database import Database as TDatabase
    from genestrip_tpu_torch.store.table import TableBuilder as TBuilder
    from genestrip_tpu_torch.tax.small import SmallTaxTree as TTree

    Database, Builder, Tree = ((JDatabase, JBuilder, JTree) if writer == "jax"
                               else (TDatabase, TBuilder, TTree))
    Other = TDatabase if writer == "jax" else JDatabase
    rng = np.random.default_rng(31)
    b = Builder(31)
    for t in range(5):
        b.add(rng.integers(0, 1 << 62, 2000, dtype=np.uint64), str(100 + t))
    table = b.build()
    taxids = ["1"] + [str(100 + t) for t in range(5)]
    tree = Tree(taxids, taxids, [-1] * 6, [-1, 0, 0, 0, 0, 0],
                np.zeros(6, bool))
    p = tmp_path / "db.zip"
    Database(table, tree, {}).save(p, include_hash=True)
    a, o = Database.load(p), Other.load(p)
    assert a.md5 == o.md5 and a.k == o.k
    np.testing.assert_array_equal(a.table.keys, o.table.keys)
    np.testing.assert_array_equal(a.table.value_idx, o.table.value_idx)
    assert a.table.values == o.table.values
    assert a.tree.taxids == o.tree.taxids
    np.testing.assert_array_equal(a.tree.ancestor_at_depth,
                                  o.tree.ancestor_at_depth)
    np.testing.assert_array_equal(a.prebuilt_hash.rows, o.prebuilt_hash.rows)
    np.testing.assert_array_equal(a.prebuilt_hash.vidx_of_slot,
                                  o.prebuilt_hash.vidx_of_slot)
    assert a.stats() == o.stats()
