"""The port's dense pass (genestrip_tpu_torch/ops/dense_pass.py) against the
JAX package's Pallas kernel (interpret mode) and its XLA lowering, on the
planted-match world of tests/test_pallas_lookup.py.

Tolerance: exact equality of every packed int32 word.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from genestrip_tpu.ops.pallas_lookup import dense_pass_pallas, dense_pass_xla  # noqa: E402
from genestrip_tpu_torch.ops.dense_pass import dense_pass, dense_pass_torch  # noqa: E402


def planted_world(seed, NB, R, vb):
    """Random rows and scratch lanes, with exact matches planted on a subset
    (as tests/test_pallas_lookup.py does, vectorized)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(-2**31, 2**31, (NB, 8), dtype=np.int64).astype(np.int32)
    sh = rng.integers(-2**31, 2**31, (NB, R), dtype=np.int64).astype(np.int32)
    sw = rng.integers(0, 2**(32 - vb), (NB, R), dtype=np.int64).astype(np.int32)
    hit = rng.random((NB, R)) < 0.4
    j = rng.integers(0, 4, (NB, R))
    hit[np.arange(NB) % 7 != 0] = False
    b, r = np.nonzero(hit)
    jj = j[b, r]
    sh[b, r] = rows[b, jj]
    sw[b, r] = ((rows[b, 4 + jj].astype(np.int64) & 0xFFFFFFFF) >> vb).astype(np.int32)
    # empty slots (vidx all ones) must never match, even when h2/want agree
    e = b[::5], jj[::5]
    rows[e[0], 4 + e[1]] |= np.int32((1 << vb) - 1)
    return rows, sh, sw


@pytest.mark.parametrize("vb", [16, 23])
def test_dense_pass_matches_pallas_and_xla(vb):
    rows, sh, sw = planted_world(vb, 4096, 4, vb)
    want_p = np.asarray(dense_pass_pallas(jnp.asarray(rows), jnp.asarray(sh),
                                          jnp.asarray(sw), vb=vb, tile=512,
                                          interpret=True))
    want_x = np.asarray(dense_pass_xla(jnp.asarray(rows), jnp.asarray(sh),
                                       jnp.asarray(sw), vb=vb))
    t = [torch.from_numpy(a) for a in (rows, sh, sw)]
    got_plain = dense_pass_torch(*t, vb=vb).numpy()
    got = dense_pass(*t, vb=vb).numpy()     # CPU tensors: the plain version
    np.testing.assert_array_equal(want_p, want_x)
    np.testing.assert_array_equal(got_plain, want_x)
    np.testing.assert_array_equal(got, want_x)
    assert (got >= 0).sum() > 100            # the planted matches are found


@pytest.mark.parametrize("R", [1, 6])
def test_dense_pass_other_lane_counts(R):
    rows, sh, sw = planted_world(R, 1024, R, 20)
    want = np.asarray(dense_pass_xla(jnp.asarray(rows), jnp.asarray(sh),
                                     jnp.asarray(sw), vb=20))
    got = dense_pass(*[torch.from_numpy(a) for a in (rows, sh, sw)], vb=20)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_path_does_not_count_launches():
    rows, sh, sw = planted_world(3, 256, 4, 16)
    before = dense_pass.launches
    dense_pass(*[torch.from_numpy(a) for a in (rows, sh, sw)], vb=16)
    assert dense_pass.launches == before


@pytest.mark.parametrize("case", ["dtype", "noncontiguous", "vb", "shape",
                                  "rows_width"])
def test_wrapper_rejects_bad_input(case):
    rows, sh, sw = (torch.from_numpy(a)
                    for a in planted_world(5, 256, 4, 16))
    vb = 16
    err = ValueError
    if case == "dtype":
        sh, err = sh.to(torch.int64), TypeError
    elif case == "noncontiguous":
        sw = torch.cat([sw, sw], dim=1)[:, ::2]
    elif case == "vb":
        vb = 30
    elif case == "shape":
        sh = sh[:, :2].contiguous()
    elif case == "rows_width":
        rows = rows[:, :4].contiguous()
    with pytest.raises(err):
        dense_pass(rows, sh, sw, vb=vb)
