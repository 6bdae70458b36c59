"""The port's scatter-join lookup (genestrip_tpu_torch/store/hash.py
lookup_join, with its dense pass) against the JAX package's, on the worlds
of tests/test_hash.py and through both fallback branches.

Tolerance: exact equality of slot ids, found flags and value indexes.
"""

import pytest

pytest.importorskip("torch")

from genestrip_tpu.store import hash as jhash  # noqa: E402
from genestrip_tpu_torch.store import hash as thash  # noqa: E402
from test_torch_hash import (  # noqa: E402
    WORLDS, _assert_equal, _jax, _port, _random_queries, _world,
)


@pytest.mark.parametrize("name", list(WORLDS))
def test_lookup_join_matches_jax(name):
    keys, vidx, q = WORLDS[name]
    ht = jhash.build_hash(keys, vidx)
    want = _jax(jhash.lookup_join, ht, q)
    _assert_equal(_port(thash.lookup_join, ht, q), want)
    # and the join agrees with the two-gather lookup
    _assert_equal(want, _jax(jhash.lookup_hash, ht, q))


@pytest.mark.parametrize("kw", [{"r_lanes": 1}, {"r_lanes": 1,
                                                 "fallback_cap": 64}],
                         ids=["compacted_fallback", "full_fallback"])
def test_lookup_join_fallback_branches(kw):
    """r_lanes=1 forces mass rank overflow (the compacted fallback); a tiny
    fallback_cap on top forces the full two-gather branch."""
    keys, vidx = _world(40_000, seed=17)
    q = _random_queries(keys, 19, 20_000, 20_000)
    ht = jhash.build_hash(keys, vidx)
    _assert_equal(_port(thash.lookup_join, ht, q, **kw),
                  _jax(jhash.lookup_join, ht, q, **kw))
