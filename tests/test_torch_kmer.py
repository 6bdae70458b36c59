"""The port's window_kmers (genestrip_tpu_torch/ops/kmer.py) against the JAX
package's, on the same padded batches.

Tolerance: exact equality — the (hi, lo) halves as unsigned 32-bit values
(garbage windows included) and the clean/exists masks.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from genestrip_tpu.ops.kmer import window_kmers as window_kmers_jax  # noqa: E402
from genestrip_tpu_torch.ops.kmer import window_kmers  # noqa: E402


def batch(seed, B, L, bad_frac):
    """Padded [B, L] code batch with random lengths in [0, L], bad bases
    (codes 4..255) sprinkled in, and BAD (255) padding."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, L), dtype=np.int64).astype(np.uint8)
    bad = rng.random((B, L)) < bad_frac
    codes[bad] = rng.integers(4, 256, int(bad.sum())).astype(np.uint8)
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    lengths[0] = L
    codes[np.arange(L)[None, :] >= lengths[:, None]] = 255
    return codes, lengths


def assert_same(codes, lengths, k):
    want = [np.asarray(x) for x in
            window_kmers_jax(jnp.asarray(codes), jnp.asarray(lengths), k)]
    got = [x.numpy() for x in
           window_kmers(torch.from_numpy(codes), torch.from_numpy(lengths), k)]
    for w, g in zip(want[:2], got[:2]):
        assert g.min() >= 0 and g.max() < 2**32
        np.testing.assert_array_equal(g.astype(np.uint32), w)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])


@pytest.mark.parametrize("k", [1, 15, 16, 17, 31])
def test_window_kmers_matches_jax(k):
    codes, lengths = batch(k, 16, 64, 0.03)
    assert_same(codes, lengths, k)


@pytest.mark.parametrize("k", [11, 31])
def test_window_kmers_length_equals_k(k):
    codes, lengths = batch(100 + k, 8, k, 0.05)
    assert_same(codes, lengths, k)


def test_window_kmers_all_bad_and_empty_reads():
    codes = np.full((4, 40), 255, np.uint8)
    codes[1, :20] = 4                        # 'N' run
    lengths = np.array([0, 20, 40, 3], np.int32)
    assert_same(codes, lengths, 7)
