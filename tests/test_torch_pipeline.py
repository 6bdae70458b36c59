"""The port's accumulating device step (genestrip_tpu_torch/match/pipeline.py
match_accum_step) against the JAX package's, on the world of
tests/test_match_parity.py over its (tax_err, class_err, threshold) grid.

Each case runs one batch large enough (B·W >= 2^16) to take the
scatter-join lookup with its dense pass. The first case also folds a small
batch that takes the two-gather lookup and a long-read batch whose per-read
words use the wide (words == 3) layout into the same state.

Tolerance: exact equality of the packed per-read words, the labels, the
`seen` and `counts` vectors and every node-state vector.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_match_parity import K, build_world, make_reads  # noqa: E402

from genestrip_tpu.io.reads import BatchPacker  # noqa: E402
from genestrip_tpu.match import pipeline as jp  # noqa: E402
from genestrip_tpu_torch.match import pipeline as tp  # noqa: E402
from genestrip_tpu_torch.match.arrays import match_arrays_from_numpy  # noqa: E402

CPU = torch.device("cpu")


def _batches(rng, genomes):
    """[big batch (B·W >= 2^16), small batch, one long read]."""
    reads = make_reads(rng, genomes, n_reads=640)
    pk = BatchPacker(600)
    for d, s in reads:
        pk.add(d.encode(), s)
    big, small = pk.flush(), pk.flush()
    g = b"".join(genomes.values())
    long_seq = (g * 3)[:9000]
    pk = BatchPacker(4)
    pk.add(b"long", long_seq)
    pk.add(b"long2", bytes(reversed(long_seq[:7000])))
    wide = pk.flush()
    return [(big.codes, big.lengths), (small.codes, small.lengths),
            (wide.codes, wide.lengths)]


def _run_both(cfg_kw, table, small, batches):
    cfg_j = jp.MatchConfig(k=K, return_labels=True, with_counts=True, **cfg_kw)
    cfg_t = tp.MatchConfig(k=K, return_labels=True, with_counts=True, **cfg_kw)
    sa, spec = jp.build_match_arrays(table, small)
    T = len(small)
    anc = small.ancestor_at_depth
    arr = match_arrays_from_numpy(np.asarray(sa["rows"]), np.asarray(sa["vaux"]),
                                  anc, CPU)
    tspec = tp.TableSpec(spec.n, spec.nb_bits)
    j_state = (jnp.zeros(spec.n + 1, jnp.uint8), jnp.zeros(spec.n + 1, jnp.int32),
               jp.node_state_init(T))
    t_state = (torch.zeros(spec.n + 1, dtype=torch.uint8),
               torch.zeros(spec.n + 1, dtype=torch.int32),
               tp.node_state_init(T, CPU))
    for bno, (codes, lengths) in enumerate(batches):
        L = codes.shape[1]
        assert (jp.per_read_layout(T, L - K + 1, L)[0] == 3) == (L > 8000)
        bounds = jp.error_bounds(lengths, K, cfg_j)
        pk_j, lab_j, *j_state = jp.match_accum_step(
            cfg_j, spec, T, sa["rows"], sa["vaux"], jnp.asarray(anc),
            jnp.asarray(codes), jnp.asarray(lengths), jnp.asarray(bounds),
            *j_state, jnp.int32(bno))
        pk_t, lab_t, *t_state = tp.match_accum_step(
            cfg_t, tspec, T, arr["rows"], arr["vaux"], arr["anc"],
            torch.from_numpy(codes), torch.from_numpy(lengths),
            torch.from_numpy(bounds), *t_state, bno)
        np.testing.assert_array_equal(pk_t.numpy(), np.asarray(pk_j))
        np.testing.assert_array_equal(lab_t.numpy(), np.asarray(lab_j))
        np.testing.assert_array_equal(t_state[0].numpy(), np.asarray(j_state[0]))
        np.testing.assert_array_equal(t_state[1].numpy(), np.asarray(j_state[1]))
        j_ns = jax.tree_util.tree_map(np.asarray, j_state[2])
        assert set(t_state[2]) == set(j_ns)
        for name, v in j_ns.items():
            np.testing.assert_array_equal(t_state[2][name].numpy(), v, err_msg=name)
    return pk_t, lab_t


@pytest.mark.parametrize("tax_err,class_err,threshold", [
    (-1.0, -1.0, 1), (0.5, -1.0, 1), (3.0, 0.2, 1),
    (-1.0, -1.0, 2), (-1.0, -1.0, 5), (0.5, 0.3, 3),
])
def test_match_accum_step_matches_jax(tmp_path, tax_err, class_err, threshold):
    rng = np.random.default_rng(12345 + int(tax_err * 10) + int(class_err * 10)
                                + 1000 * threshold)
    table, small, genomes = build_world(tmp_path, rng)
    batches = _batches(rng, genomes)
    codes, lengths = batches[0]
    assert codes.shape[0] * (codes.shape[1] - K + 1) >= tp._JOIN_MIN_Q
    if (tax_err, class_err, threshold) != (-1.0, -1.0, 1):
        batches = batches[:1]
    _run_both(dict(max_read_tax_error=tax_err, max_read_class_error=class_err,
                   threshold=threshold), table, small, batches)


def test_classify_off_matches_jax(tmp_path):
    rng = np.random.default_rng(99)
    table, small, genomes = build_world(tmp_path, rng)
    _run_both(dict(classify=False), table, small, _batches(rng, genomes)[:1])
