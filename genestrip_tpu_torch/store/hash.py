"""Quotient-packed two-choice (cuckoo-style) hash — the fast device lookup.

Reference equivalent: the lookup role of store/KMerSortedArray.java:298-349
(bloom probe + binary search) and store/RadixKMerStore.java:38-88 (radix
buckets + in-bucket search). This layout needs exactly TWO [8]i32 row
gathers per lookup (one per bucket choice), with the value index packed
into the row, where a radix binary search needs 5-6.

Exactness (no false positives) by quotienting:
  * The 64-bit key container (hi, lo) is mixed by a 2-round Feistel
    bijection -> (h2, l2).
  * bucket1 = l2 & (NB-1); rem2 = l2 >> nb  (nb = log2(NB)).
  * bucket2 = bucket1 ^ (g(h2, rem2) | 1)   (cuckoo XOR trick: bucket1 is
    recoverable from bucket2 and the remainder, so storing WHICH choice was
    used makes (bucket, choice, h2, rem2) reconstruct the full key).
  * A slot stores h2 (plane1) and [rem2 | choice | vidx] (plane2). A query
    matches iff h2, rem2 AND the choice bit agree — that pins l2's bucket
    bits, i.e. the whole 64-bit key. Exact, zero false positives.

Bucket = 4 slots = one [8]i32 row: 4x plane1 then 4x plane2. Two-choice
placement at load <= 0.5 practically never overflows; on overflow the
builder doubles NB and retries.

The *slot id* (bucket*4 + lane) replaces the sorted-array storage position
(ref KMerSortedArray posStore) as the stable k-mer index feeding exact
unique counting (ref KMerUniqueCounterBits) — the semantics only need a
stable bijection, which slot ids provide via slot_of_entry.

Value-index capacity: vidx gets nb-1 bits (>= 16 since NB >= 2^17), so
large tables naturally support value spaces far beyond the sorted-array
cap of 65535 (ref RadixKMerStore maxValuesForRadix).

Port note (PyTorch): the host half (build_hash, _place,
vidx_of_slot_from_rows, max_values_for, the numpy Feistel) is a copy of
genestrip_tpu/store/hash.py. The two device lookups are ported to torch at
the end of this module, for one device: the sharded-DB `axis` mode of
lookup_join is not ported yet (ROADMAP queue 1).
"""

from __future__ import annotations

import numpy as np
import torch

from genestrip_tpu_torch.ops.dense_pass import dense_pass

BUCKET = 4
MIN_NB_BITS = 17          # vidx gets nb-1 >= 16 bits


def _feistel_np(hi: np.ndarray, lo: np.ndarray):
    """2-round Feistel mix of the 64-bit container; bijective."""
    hi = hi.astype(np.uint32)
    lo = lo.astype(np.uint32)
    def mix(x, c):
        x = (x ^ (x >> np.uint32(16))) * np.uint32(c)
        x = (x ^ (x >> np.uint32(13))) * np.uint32(0xC2B2AE35)
        return x ^ (x >> np.uint32(16))
    h1 = hi ^ mix(lo, 0x85EBCA6B)
    l1 = lo ^ mix(h1, 0x9E3779B1)
    return h1, l1


def _g_np(h2: np.ndarray, rem2: np.ndarray, mask: np.uint32):
    g = (h2 * np.uint32(0x27D4EB2F)) ^ (rem2 * np.uint32(0x165667B1))
    g ^= g >> np.uint32(15)
    return (g & mask) | np.uint32(1)


class KmerHashTable:
    """Device-ready quotient hash of a KmerTable (derived data, built at load).

    Attributes:
      rows: [NB, 8] int32 — per bucket: 4x h2 then 4x (rem2|choice|vidx).
      nb_bits: log2(number of buckets).
      slot_of_entry: [N] int64 — table entry -> slot id (bucket*4 + lane).
      vidx_of_slot: [NB*4] int32 value index per slot (-1 = empty), for
        aggregating slot-indexed unique counts per value on the host.
    """

    def __init__(self, rows, nb_bits, slot_of_entry, vidx_of_slot):
        self.rows = rows
        self.nb_bits = nb_bits
        self.slot_of_entry = slot_of_entry
        self.vidx_of_slot = vidx_of_slot

    @property
    def nb(self) -> int:
        return 1 << self.nb_bits

    @property
    def n_slots(self) -> int:
        return self.nb * BUCKET

    @property
    def vidx_bits(self) -> int:
        return self.nb_bits - 1


def vidx_of_slot_from_rows(rows: np.ndarray, nb_bits: int) -> np.ndarray:
    """Derive the per-slot value index from the packed rows (plane2's low
    nb-1 bits; the all-ones pattern marks an empty slot). Lets persisted
    hashes store only rows + slot_of_entry (store/database.py)."""
    vb = nb_bits - 1
    empty = np.uint32((1 << vb) - 1)
    plane2 = rows.view(np.uint32)[:, 4:].reshape(-1)   # slot id order
    v = (plane2 & empty).astype(np.int64)
    return np.where(v == empty, -1, v)


def max_values_for(n_keys: int) -> int:
    """Value-space capacity of the hash layout for a table of n_keys."""
    nb_bits = max(int(np.ceil(np.log2(max(2 * n_keys, 1) / BUCKET + 1))), MIN_NB_BITS)
    return (1 << (nb_bits - 1)) - 1   # all-ones vidx is the empty marker


def build_hash(keys: np.ndarray, value_idx: np.ndarray) -> KmerHashTable:
    """Builds the quotient hash host-side (vectorized numpy).

    keys: [N] uint64 distinct canonical k-mers; value_idx: [N] integer
    value indices (must fit in nb-1 bits; all-ones reserved for empty).
    """
    n = len(keys)
    keys = np.asarray(keys, dtype=np.uint64)
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    h2, l2 = _feistel_np(hi, lo)

    nb_bits = max(int(np.ceil(np.log2(max(2 * n, 1) / BUCKET + 1))), MIN_NB_BITS)
    # widen buckets until the value-index space fits (vidx gets nb-1 bits,
    # all-ones reserved as the empty marker)
    max_vidx = int(np.max(value_idx)) if n else 0
    while (1 << (nb_bits - 1)) - 1 <= max_vidx:
        nb_bits += 1
    while True:
        nb = 1 << nb_bits
        mask = np.uint32(nb - 1)
        b1 = (l2 & mask).astype(np.int64)
        rem2 = (l2 >> np.uint32(nb_bits)).astype(np.uint32)
        b2 = (b1 ^ _g_np(h2, rem2, mask).astype(np.int64))
        placed = _place(b1, b2, nb)
        if placed is not None:
            break
        nb_bits += 1

    bucket_of, lane_of, choice_of = placed
    vb = nb_bits - 1
    empty = (1 << vb) - 1
    vidx = np.asarray(value_idx, dtype=np.int64)
    if np.any(vidx >= empty) or np.any(vidx < 0):
        raise ValueError(f"value index out of range for hash layout "
                         f"(max {empty - 1})")
    slot = bucket_of * BUCKET + lane_of

    rows = np.zeros((nb, 8), np.uint32)
    rows[:, 4:] = np.uint32(empty)   # choice=0, rem2=0, vidx=all-ones: empty
    plane2 = ((rem2.astype(np.uint64) << np.uint64(vb + 1))
              | (choice_of.astype(np.uint64) << np.uint64(vb))
              | vidx.astype(np.uint64)).astype(np.uint32)
    rows[bucket_of, lane_of] = h2
    rows[bucket_of, 4 + lane_of] = plane2

    vidx_of_slot = np.full(nb * BUCKET, -1, np.int64)
    vidx_of_slot[slot] = vidx
    return KmerHashTable(rows.view(np.int32), nb_bits,
                         slot.astype(np.int64), vidx_of_slot)


def _place(b1, b2, nb):
    """Two-choice cuckoo placement with eviction; (bucket, lane, choice) or None.

    Phase 1: two vectorized greedy rounds (everyone tries b1, losers try b2)
    — places ~all keys at load <= 0.5. Phase 2: vectorized random-walk
    eviction for the stragglers (one actor per bucket per round; a full
    bucket evicts a random victim, which re-joins the pending set with its
    other choice). Load 0.5 on 4-slot two-choice buckets is far below the
    cuckoo capacity bound, so the walk terminates in a handful of rounds."""
    n = len(b1)
    # int32 throughout: bucket ids < nb <= ~2^27 and entry ids < n < 2^31,
    # halving the dominant argsort/copy/scatter costs (measured ~1.7x
    # faster end-to-end on a 16M-key build vs the int64 original)
    b1 = b1.astype(np.int32)
    b2 = b2.astype(np.int32)
    bucket_of = np.full(n, -1, np.int32)
    lane_of = np.full(n, -1, np.int32)
    choice_of = np.zeros(n, np.uint32)
    fill = np.zeros(nb, np.int32)
    slot_key = np.full(nb * BUCKET, -1, np.int32)

    pending = np.arange(n, dtype=np.int32)
    cur = b1.copy()
    alt = b2.copy()
    cur_c = np.zeros(n, np.uint32)

    def greedy_round(pending):
        want = cur[pending]
        order = np.argsort(want, kind="stable").astype(np.int32)
        w_sorted = want[order]
        first = np.ones(len(order), bool)
        first[1:] = w_sorted[1:] != w_sorted[:-1]
        pos = np.arange(len(order), dtype=np.int32)
        seg_start = np.maximum.accumulate(np.where(first, pos, 0))
        rank = pos - seg_start
        lane = fill[w_sorted] + rank
        ok = lane < BUCKET
        idx = pending[order]
        win = idx[ok]
        bucket_of[win] = w_sorted[ok]
        lane_of[win] = lane[ok].astype(np.int32)
        choice_of[win] = cur_c[win]
        slot_key[w_sorted[ok] * BUCKET + lane[ok]] = win
        np.add.at(fill, w_sorted[ok], 1)
        return idx[~ok]

    def swap_to_alt(keys):
        c = cur[keys].copy()
        cur[keys] = alt[keys]
        alt[keys] = c
        cur_c[keys] ^= np.uint32(1)

    for _ in range(2):
        if len(pending) == 0:
            return bucket_of, lane_of, choice_of
        pending = greedy_round(pending)
        swap_to_alt(pending)

    rng = np.random.default_rng(0x9E3779B1)
    for _ in range(2000):
        if len(pending) == 0:
            return bucket_of, lane_of, choice_of
        want = cur[pending]
        order = np.argsort(want, kind="stable").astype(np.int32)
        w_sorted = want[order]
        first = np.ones(len(order), bool)
        first[1:] = w_sorted[1:] != w_sorted[:-1]
        idx = pending[order]
        act, wb = idx[first], w_sorted[first]     # one actor per bucket
        waiters = idx[~first]
        free = fill[wb] < BUCKET
        fa, fb = act[free], wb[free]
        lane = fill[fb]
        bucket_of[fa] = fb
        lane_of[fa] = lane.astype(np.int32)
        choice_of[fa] = cur_c[fa]
        slot_key[fb * BUCKET + lane] = fa
        fill[fb] += 1
        ea, eb = act[~free], wb[~free]
        lane = rng.integers(0, BUCKET, len(ea))
        victim = slot_key[eb * BUCKET + lane]
        bucket_of[ea] = eb
        lane_of[ea] = lane.astype(np.int32)
        choice_of[ea] = cur_c[ea]
        slot_key[eb * BUCKET + lane] = ea
        # victim re-joins pending, targeting its other bucket
        bucket_of[victim] = -1
        v_other_is_b2 = b1[victim] == eb
        cur[victim] = np.where(v_other_is_b2, b2[victim], b1[victim])
        alt[victim] = eb
        cur_c[victim] = v_other_is_b2.astype(np.uint32)
        pending = np.concatenate([waiters, victim])
    return None


# ---------------------------------------------------------------------------
# device lookup (torch)
# ---------------------------------------------------------------------------
#
# The JAX lookups take uint32 query halves and compute in 32-bit lanes.
# PyTorch has no uint32 shifts or compares on the CPU, so here the halves are
# int64 tensors holding the unsigned 32-bit values (int32 bit patterns are
# accepted too), and the mixing runs in int64 masked to 32 bits. Outputs have
# the JAX values; slot and vidx come back as int64.
#
# Every scatter keeps the JAX package's dummy-slot convention: JAX drops an
# out-of-range scatter index silently, torch raises on the CPU and asserts on
# CUDA. Set-scatters have unique targets apart from the dummy slot, so their
# result is deterministic on CUDA too.

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """(x * c) mod 2^32 for x in [0, 2^32), with no int64 overflow."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix(x, c: int):
    x = _mul32(x ^ (x >> 16), c)
    x = _mul32(x ^ (x >> 13), 0xC2B2AE35)
    return x ^ (x >> 16)


def _hash_queries(q_hi, q_lo, nb_bits: int):
    """(h2, rem2, b1, b2) of flattened queries: the Feistel mix and the two
    cuckoo buckets, as in genestrip_tpu's lookup_hash/lookup_join."""
    h2 = q_hi ^ _mix(q_lo, 0x85EBCA6B)
    l2 = q_lo ^ _mix(h2, 0x9E3779B1)
    mask = (1 << nb_bits) - 1
    b1 = l2 & mask
    rem2 = l2 >> nb_bits
    g = _mul32(h2, 0x27D4EB2F) ^ _mul32(rem2, 0x165667B1)
    g = ((g ^ (g >> 15)) & mask) | 1
    return h2, rem2, b1, b1 ^ g


def _flat_u32(x):
    return x.reshape(-1).to(torch.int64) & _M32


def _entry_count_bits(e: int) -> int:
    return max(int(np.ceil(np.log2(e + 2))), 1)


def lookup_join(rows, q_hi, q_lo, *, nb_bits: int, r_lanes: int = 0,
                fallback_cap: int = 8192):
    """Exact scatter-join hash lookup; contract == lookup_hash.

    Port of genestrip_tpu/store/hash.py::lookup_join for one device. rows:
    [NB, 8] int32 on the lookup's device; q_hi/q_lo: query halves, any
    shape. Returns (slot [n_slots where miss], found bool, vidx [-1 where
    miss]). The dense pass is ops.dense_pass.dense_pass: the CUDA kernel for
    tensors on the card, its plain version for tensors on the CPU.
    """
    shape = q_hi.shape
    dev = rows.device
    q_hi, q_lo = _flat_u32(q_hi), _flat_u32(q_lo)
    Q = q_hi.shape[0]
    E = 2 * Q
    nb = 1 << nb_bits
    vb = nb_bits - 1
    empty = (1 << vb) - 1
    if not r_lanes:
        lam = E / nb
        r_lanes = 4 if lam <= 0.5 else (6 if lam <= 1.0 else 8)
    R = r_lanes
    FB = min(fallback_cap, Q)

    h2, rem2, b1, b2 = _hash_queries(q_hi, q_lo, nb_bits)
    want1 = rem2 << 1
    e_b = torch.cat([b1, b2])
    e_h = torch.cat([h2, h2])
    e_h = torch.where(e_h > 0x7FFFFFFF, e_h - (1 << 32), e_h)   # as int32
    e_w = torch.cat([want1, want1 | 1])
    qid = torch.arange(Q, device=dev)
    e_q = torch.cat([qid, qid])

    # JAX sorts the entries by (bucket, h2, want), the query id riding
    # along. Those keys hold 65 bits, one more than an int64, so the port
    # sorts twice, stably: by want, then by (bucket, h2). Equal wants share
    # their choice bit, so ties keep query-id order, as in JAX.
    p1 = torch.sort(e_w, stable=True).indices
    p2 = torch.sort((e_b[p1] << 32) | (e_h[p1] + (1 << 31)), stable=True).indices
    perm = p1[p2]
    s_b, s_h, s_w, s_q = e_b[perm], e_h[perm], e_w[perm], e_q[perm]

    def shifted(x, fill):
        return torch.cat([torch.full((1,), fill, dtype=x.dtype, device=dev),
                          x[:-1]])

    new_bucket = s_b != shifted(s_b, -1)
    new_key = new_bucket | (s_h != shifted(s_h, 0)) | (s_w != shifted(s_w, -1))
    pos = torch.arange(E, device=dev)
    kidx = torch.cumsum(new_key, 0)
    bstart_k = torch.cummax(torch.where(new_bucket, kidx, 0), 0).values
    rank = kidx - bstart_k

    lane_ok = new_key & (rank < R)
    tgt = torch.where(lane_ok, s_b * R + rank, nb * R)
    # pack (want, pos) into one scratch plane when the bits fit: want has
    # 33 - nb_bits significant bits, pos needs log2(E + 2)
    wbits = 33 - nb_bits
    pbits = _entry_count_bits(E)
    sc_h = torch.zeros(nb * R + 1, dtype=torch.int32, device=dev)
    sc_h[tgt] = s_h.to(torch.int32)
    if wbits + pbits <= 32:
        wp = (s_w << pbits) | pos
        wp = torch.where(wp > 0x7FFFFFFF, wp - (1 << 32), wp)
        sc_wp = torch.full((nb * R + 1,), -1, dtype=torch.int32, device=dev)
        sc_wp[tgt] = wp.to(torch.int32)
        sw2 = sc_wp[:-1].view(nb, R)
        # logical shift of the int32 bit pattern
        sw_probe = (sw2 >> pbits) & ((1 << (32 - pbits)) - 1)
        sp2 = sw2 & ((1 << pbits) - 1)
    else:
        sc_w = torch.full((nb * R + 1,), -1, dtype=torch.int32, device=dev)
        sc_w[tgt] = s_w.to(torch.int32)
        sc_p = torch.zeros(nb * R + 1, dtype=torch.int32, device=dev)
        sc_p[tgt] = pos.to(torch.int32)
        sw_probe = sc_w[:-1].view(nb, R)
        sp2 = sc_p[:-1].view(nb, R)
    sh2 = sc_h[:-1].view(nb, R)

    # dense pass: [NB, R] scratch lanes vs the 4 slots of each row
    w = dense_pass(rows, sh2, sw_probe, vb=vb)
    fnd = w >= 0
    v = (w & empty).to(torch.int64)
    lane = (w >> vb).to(torch.int64)
    slot = torch.arange(nb, device=dev)[:, None] * BUCKET + lane

    # scatter back to entry space. An unoccupied packed lane (-1) that
    # happens to compare equal decodes to pos 2^pbits - 1 > E: JAX drops
    # that out-of-range scatter, here it goes to the dummy slot E.
    sp_flat = sp2.reshape(-1).to(torch.int64)
    p_flat = torch.where(fnd.reshape(-1) & (sp_flat < E), sp_flat, E)
    r_v = torch.full((E + 1,), -1, dtype=torch.int64, device=dev)
    r_v[p_flat] = v.reshape(-1)
    r_s = torch.full((E + 1,), -1, dtype=torch.int64, device=dev)
    r_s[p_flat] = slot.reshape(-1)
    r_ok = torch.zeros(E + 1, dtype=torch.int64, device=dev)
    r_ok[torch.where(lane_ok, pos, E)] = 1

    # broadcast along equal-key runs (run-first holds the result)
    run_first = torch.cummax(torch.where(new_key, pos, 0), 0).values
    rv_b, rs_b, rok_b = r_v[run_first], r_s[run_first], r_ok[run_first]

    # combine per query: at most one of a query's two entries can be found
    env = torch.zeros(Q, dtype=torch.int64, device=dev).scatter_reduce_(
        0, s_q, torch.where(rv_b >= 0, rv_b + 1, 0), "amax")
    slot_q = torch.full((Q,), -1, dtype=torch.int64, device=dev).scatter_reduce_(
        0, s_q, rs_b, "amax")
    n_lanes = torch.zeros(Q, dtype=torch.int64, device=dev).index_add_(
        0, s_q, rok_b)
    found = env > 0
    vidx = torch.where(found, env - 1, -1)
    resolved = found | (n_lanes == 2)

    # fallback: the unresolved queries (stable, first), two-gathered; JAX's
    # lax.cond between the two branches is a host branch here
    n_unres = int((~resolved).sum())
    if 0 < n_unres <= FB:
        fb_idx = torch.sort(resolved.to(torch.int32), stable=True).indices[:FB]
        s_fb, f_fb, v_fb = lookup_hash(rows, q_hi[fb_idx], q_lo[fb_idx],
                                       nb_bits=nb_bits)
        found[fb_idx] = f_fb
        vidx[fb_idx] = v_fb
        slot_q[fb_idx] = torch.where(f_fb, s_fb, -1)
    elif n_unres > FB:
        s_all, found, vidx = lookup_hash(rows, q_hi, q_lo, nb_bits=nb_bits)
        slot_q = torch.where(found, s_all, -1)

    slot_out = torch.where(found, slot_q, nb * BUCKET)
    return (slot_out.reshape(shape), found.reshape(shape), vidx.reshape(shape))


def lookup_hash(rows, q_hi, q_lo, *, nb_bits: int, bucket_lo=None):
    """Two-gather exact hash lookup; port of
    genestrip_tpu/store/hash.py::lookup_hash.

    rows: [NB, 8] int32; q_hi/q_lo: query halves, any shape. Returns (slot
    [NB*4 where not found — a dummy scatter target], found bool, vidx [-1
    where not found]). With `bucket_lo`, rows holds only the bucket range
    [bucket_lo, bucket_lo + rows.shape[0]); probes of other buckets report
    not-found.
    """
    shape = q_hi.shape
    q_hi, q_lo = _flat_u32(q_hi), _flat_u32(q_lo)
    h2, rem2, b1, b2 = _hash_queries(q_hi, q_lo, nb_bits)
    nb = 1 << nb_bits
    vb = nb_bits - 1
    empty = (1 << vb) - 1

    if bucket_lo is None:
        r1, r2 = rows[b1], rows[b2]                 # [Q, 8]
        own1 = own2 = None
    else:
        nb_local = rows.shape[0]
        lb1, lb2 = b1 - bucket_lo, b2 - bucket_lo
        own1 = (lb1 >= 0) & (lb1 < nb_local)
        own2 = (lb2 >= 0) & (lb2 < nb_local)
        r1 = rows[lb1.clamp(0, nb_local - 1)]
        r2 = rows[lb2.clamp(0, nb_local - 1)]

    def probe(r, choice, own):
        r = r.to(torch.int64) & _M32
        want_hi = (rem2 << 1) | choice
        f = torch.zeros_like(h2, dtype=torch.bool)
        lane = torch.zeros_like(h2)
        v = torch.zeros_like(h2)
        for j in range(BUCKET):
            kj, pj = r[:, j], r[:, BUCKET + j]
            vj = pj & empty
            eqj = (kj == h2) & ((pj >> vb) == want_hi) & (vj != empty)
            first = eqj & ~f
            lane = torch.where(first, j, lane)
            v = torch.where(first, vj, v)
            f = f | eqj
        if own is not None:
            f = f & own
        return f, lane, v

    f1, l1, v1 = probe(r1, 0, own1)
    f2, l2, v2 = probe(r2, 1, own2)
    found = f1 | f2
    bucket = torch.where(f1, b1, b2)
    lane = torch.where(f1, l1, l2)
    slot = torch.where(found, bucket * BUCKET + lane, nb * BUCKET)
    vidx = torch.where(found, torch.where(f1, v1, v2), -1)
    return (slot.reshape(shape), found.reshape(shape), vidx.reshape(shape))
