"""The batched read-classification device pipeline (PyTorch port of
genestrip_tpu/match/pipeline.py) — the hot path.

Each [B, L] batch goes through `match_accum_step`: `match_step` computes the
window k-mers (ops/kmer.py), the exact hash lookup (store/hash.py: the
scatter-join `lookup_join` with its dense-pass kernel once B·W >= 2^16,
else the two-gather `lookup_hash`), the node statistics and the per-read
classification, then `fold_node_state` and `pack_per_read` fold the
per-node state and pack one int32 word (or three) per read. The algorithm,
its comments and its outputs are those of the JAX module; see its module
docstring for the why of each step. What differs:

  * Multi-key sorts (`jax.lax.sort` with num_keys=2) are one stable torch
    sort of a packed int64 key, the payload gathered by the permutation.
  * The value-table attach (`_attach_aux`, gather-free on the TPU) is a
    plain `vaux[idx]` gather; two-level scans are torch.cumsum/cummax.
  * Arithmetic runs in int64 where JAX used int32; the JAX code is written
    never to overflow int32, so the values agree. Outputs are int32 where
    the JAX outputs are.
  * `seen`, `counts` and the node state are updated in place (JAX donates
    them); the function returns them as JAX does.
  * Only the replicated-DB mode (`db_axis=None`) exists.
  * Every scatter keeps the JAX dummy-slot convention (T, E, nb*R, B*P,
    n_table): JAX drops out-of-range indices silently, torch does not.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from genestrip_tpu_torch.ops.kmer import window_kmers
from genestrip_tpu_torch.store.hash import lookup_hash, lookup_join

# flattened query count at or above which the scatter-join lookup is used
# (the same threshold as genestrip_tpu, so both packages take one branch)
_JOIN_MIN_Q = 1 << 16

_I32_MAX = 2**31 - 1

LABEL_MISS = -1
LABEL_INVALID = -2
LABEL_NONE = -3


@dataclass(frozen=True)
class MatchConfig:
    k: int
    max_paths: int = 10
    classify: bool = True
    with_unique: bool = True
    with_counts: bool = False
    max_read_tax_error: float = -1.0     # ref GSConfigKey maxReadTaxErrorCount
    max_read_class_error: float = -1.0   # ref maxReadClassErrorCount
    threshold: int = 1                   # ref minKMersForClass
    # label matrix is only needed for kraken-style output; it is a [B, W]
    # transfer per batch, so default off (Matcher enables it on demand)
    return_labels: bool = False


@dataclass(frozen=True)
class TableSpec:
    """Static lookup geometry of the quotient hash (store/hash.py):
    n = slot count (the unique-counter position space), nb_bits = log2 of
    the bucket count."""

    n: int
    nb_bits: int


def vaux_from_nov(nov: np.ndarray, tree) -> np.ndarray:
    """The small [n_values + 1, 4] value-indexed aux table of
    (node, tout(node), depth(node), pad) with a trailing miss row (as
    genestrip_tpu's build_match_arrays builds it; see match/arrays.py)."""
    nv = len(nov)
    safe = np.maximum(nov, 0)
    vaux = np.zeros((nv + 1, 4), np.int32)
    vaux[:nv, 0] = nov
    vaux[:nv, 1] = np.where(nov >= 0, tree.tout[safe], 0)
    vaux[:nv, 2] = np.where(nov >= 0, tree.depth[safe], 0)
    vaux[nv] = (-1, 0, 0, 0)   # miss row
    return vaux


def _lca_pair(anc, a, b):
    """Vectorized LCA of index tensors a, b (assumed >= 0) via ancestor table."""
    aa = anc[a]
    ab = anc[b]
    match = (aa == ab) & (aa >= 0)
    d = match.sum(dim=-1) - 1
    pick = aa.gather(-1, d.clamp(min=0)[..., None])[..., 0]
    return torch.where(d >= 0, pick, -1)


def error_bounds(lengths: np.ndarray, k: int, cfg: MatchConfig) -> np.ndarray:
    """Per-read integer error bounds, precomputed on the host in float64.

    Keeps the reference's Java-double threshold semantics without any
    64-bit math on device: a read tax-fails iff tax_err >= bounds[:, 0]
    (err > A or err > A*n_win, ref FastqKMerMatcher.java:371-379), and its
    per-tax stats count iff class_err <= bounds[:, 1] (ref :508-510).
    Disabled thresholds map to never/always via INT32_MAX.
    """
    big = np.int64(2**31 - 1)
    n = len(lengths)
    n_win = np.maximum(lengths.astype(np.int64) - (k - 1), 0).astype(np.float64)
    A = cfg.max_read_tax_error
    if A < 0:
        tb = np.full(n, big)
    elif A >= 1:
        tb = np.full(n, np.int64(np.floor(A)) + 1)
    else:
        tb = np.floor(A * n_win).astype(np.int64) + 1
    Bc = cfg.max_read_class_error
    if Bc < 0:
        cb = np.full(n, big)
    elif Bc >= 1:
        cb = np.floor(np.maximum(Bc, Bc * n_win)).astype(np.int64)
    else:
        cb = np.floor(Bc * n_win).astype(np.int64)
    return np.stack([np.minimum(tb, big), np.minimum(cb, big)],
                    axis=1).astype(np.int32)


def _sort_rows(key, *payload):
    """Stable per-row sort of an int64 key; payloads follow the permutation."""
    s_key, perm = torch.sort(key, dim=1, stable=True)
    return (s_key, perm) + tuple(p.gather(1, perm) for p in payload)


def _ceil_log2(x) -> int:
    return int(np.ceil(np.log2(x)))


def match_step(cfg: MatchConfig, spec: TableSpec, n_nodes: int,
               rows, vaux, anc, codes, lengths, err_bounds, seen, counts):
    """One batch of reads against the table; per-read and per-node stats.

    Port of genestrip_tpu/match/pipeline.py::match_step with db_axis=None.
    rows: [NB, 8] int32 quotient-hash buckets; vaux: [n_values + 1, 4]
    (node, tout, depth, pad) value table; anc: [T, D] ancestor table; codes
    [B, L] uint8; lengths [B]; err_bounds [B, 2] (error_bounds); seen
    [n_slots + 1] uint8 and counts int32 unique-counter state, updated in
    place (the last slot is a dummy scatter target). All on one device.
    """
    B, L = codes.shape
    dev = codes.device
    T = n_nodes
    n_table = spec.n
    k = cfg.k
    hi, lo, clean, exists = window_kmers(codes, lengths, k)
    W = L - k + 1
    lengths = lengths.to(torch.int64)

    lk = lookup_join if B * W >= _JOIN_MIN_Q else lookup_hash
    pos, found_win, vidx = lk(rows, hi, lo, nb_bits=spec.nb_bits)
    valid = clean & exists
    hit0 = valid & found_win
    nv = vaux.shape[0] - 1
    D = anc.shape[1]
    aux = vaux[torch.where(hit0, vidx, nv)].to(torch.int64)     # [B, W, 4]
    node = torch.where(hit0, aux[..., 0], -1)
    hit = hit0 & (node >= 0)
    tout_lab = torch.where(hit, aux[..., 1], 0)
    if cfg.classify and cfg.threshold > 1:
        depth_lab = torch.where(hit, aux[..., 2], D)
    else:
        depth_lab = torch.full((B, W), D, dtype=torch.int64, device=dev)
    label = torch.where(exists,
                        torch.where(clean, torch.where(hit, node, LABEL_MISS),
                                    LABEL_INVALID),
                        LABEL_NONE)

    n_win = (lengths - (k - 1)).clamp(min=0)
    found = hit.any(dim=1)

    # ---- unique counting (by storage position) ----------------------------
    if cfg.with_unique:
        upos = torch.where(hit, pos, n_table).reshape(-1)
        seen.index_fill_(0, upos, 1)          # == scatter-max of 1
        if cfg.with_counts:
            counts.index_add_(0, upos, torch.ones_like(upos, dtype=counts.dtype))

    # ---- contig segmentation ----------------------------------------------
    s_idx = torch.arange(W, device=dev).expand(B, W)
    row_idx = torch.arange(B, device=dev)[:, None].expand(B, W)
    col_none = torch.full((B, 1), LABEL_NONE, dtype=label.dtype, device=dev)
    prev = torch.cat([col_none, label[:, :-1]], dim=1)
    nxt = torch.cat([label[:, 1:], col_none], dim=1)
    boundary = exists & (label != prev)
    is_end = exists & (label != nxt)
    run_start = torch.cummax(torch.where(boundary, s_idx, -1), dim=1).values
    clen = s_idx - run_start + 1

    end_hit = is_end & hit
    tnode = torch.where(end_hit, label, T).reshape(-1)
    clen_f = torch.where(end_hit, clen, 0).reshape(-1)

    def node_add(vals, tgt=tnode, size=T + 1):
        return torch.zeros(size, dtype=torch.int64, device=dev).index_add_(
            0, tgt, vals)

    contigs = node_add(end_hit.reshape(-1).to(torch.int64))[:T]
    kmers = node_add(clen_f)[:T]
    # per-batch clen^2 sums in G row groups, each below 2^30 (see JAX)
    G = max(1, -(-(B * W * W) // (1 << 30)))
    Bg = -(-B // G)
    sq_val = clen_f * clen_f
    if G == 1:
        contig_sq = node_add(sq_val)[None, :T]
    else:
        grp = (row_idx // Bg).reshape(-1)
        contig_sq = node_add(sq_val, grp * (T + 1) + tnode,
                             G * (T + 1)).reshape(G, T + 1)[:, :T]
    # max contig + first achiever in one scatter-min of a composite
    enc_bits = max(_ceil_log2(B * W), 1)
    enc = s_idx + W * row_idx
    if enc_bits + _ceil_log2(W + 2) <= 31:
        comp_mc = torch.where(end_hit, ((W - clen) << enc_bits) | enc,
                              _I32_MAX).reshape(-1)
        mc = torch.full((T + 1,), _I32_MAX, dtype=torch.int64,
                        device=dev).scatter_reduce_(0, tnode, comp_mc,
                                                    "amin")[:T]
        has_mc = mc != _I32_MAX
        max_contig = torch.where(has_mc, W - (mc >> enc_bits), 0)
        argmax_enc = torch.where(has_mc, mc & ((1 << enc_bits) - 1), _I32_MAX)
    else:
        max_contig = torch.zeros(T + 1, dtype=torch.int64,
                                 device=dev).scatter_reduce_(
            0, tnode, clen_f, "amax")[:T]
        mc_lab = max_contig[label.clamp(0, T - 1)]
        is_max = end_hit & (clen == mc_lab) & (mc_lab > 0)
        argmax_enc = torch.full((T + 1,), _I32_MAX, dtype=torch.int64,
                                device=dev).scatter_reduce_(
            0, torch.where(is_max, label, T).reshape(-1),
            torch.where(is_max, enc, _I32_MAX).reshape(-1), "amin")[:T]

    # ---- per-read distinct nodes: sort of (label, s) -----------------------
    BIG = _I32_MAX
    node_key = torch.where(hit, node, BIG)
    s_key, s_first, s_tout, s_depth = _sort_rows(
        (node_key << 32) | s_idx, torch.where(hit, tout_lab, BIG), depth_lab)
    s_key = s_key >> 32
    s_node = torch.where(s_key != BIG, s_key, -1)
    col_m9 = torch.full((B, 1), -9, dtype=torch.int64, device=dev)
    sp = torch.cat([col_m9, s_node[:, :-1]], dim=1)
    sn = torch.cat([s_node[:, 1:], col_m9], dim=1)
    run_start_m = (s_node >= 0) & (s_node != sp)    # first window of each node
    run_end_m = (s_node >= 0) & (s_node != sn)

    # reads >= 1 kmer per node: one per (read, node)
    reads1 = node_add(run_start_m.reshape(-1).to(torch.int64),
                      torch.where(run_start_m, s_node, T).reshape(-1))[:T]

    out = {
        "found": found,
        "n_win": n_win,
        "contigs": contigs,
        "kmers": kmers,
        "contig_sq": contig_sq,
        "max_contig": max_contig,
        "argmax_enc": argmax_enc,
        "reads1": reads1,
        "seen": seen,
        "counts": counts,
    }
    if cfg.return_labels:
        out["label"] = label.to(torch.int32)

    if not cfg.classify:
        out["class_node"] = torch.full((B,), -1, dtype=torch.int64, device=dev)
        out["read_kmers"] = torch.zeros(B, dtype=torch.int64, device=dev)
        out["tax_err"] = torch.zeros(B, dtype=torch.int64, device=dev)
        out["stats_ok"] = torch.zeros(B, dtype=torch.bool, device=dev)
        return out

    # ---- candidate paths: maximal distinct hit nodes -----------------------
    succ = torch.where(sn >= 0, sn, BIG)
    non_max = run_end_m & (succ < s_tout)
    Wp = 1 << max(_ceil_log2(W + 1), 1)
    if T * Wp < 2**31:
        start_comp = torch.where(run_start_m, s_node * Wp + s_first, -1)
        run_first = torch.cummax(start_comp, dim=1).values & (Wp - 1)
    else:
        rs_idx = torch.cummax(torch.where(run_start_m, s_idx, 0), dim=1).values
        run_first = s_first.gather(1, rs_idx)
    cand_mask = run_end_m & ~non_max
    # first-occurrence-order cap to max_paths: sort candidates by (first
    # window, node); the run-end sorted-row position rides along
    c12, c3 = _sort_rows((torch.where(cand_mask, run_first, BIG) << 32)
                         | torch.where(cand_mask, s_node, BIG))
    P = cfg.max_paths
    c1, c2 = c12[:, :P] >> 32, c12[:, :P] & 0xFFFFFFFF
    cand = torch.where(c1 != BIG, c2, -1)
    cnt_label = torch.where(cand >= 0, c3[:, :P] + 1, 0)

    # ---- path sums: hits whose node is ancestor-or-equal -------------------
    m_key = torch.cat([torch.where(hit, tout_lab * 2, BIG),
                       torch.where(cand >= 0, cand * 2 + 1, BIG - 1)], dim=1)
    m_pay = torch.cat([torch.full((B, W), -1, dtype=torch.int64, device=dev),
                       torch.arange(P, device=dev).expand(B, P)], dim=1)
    _, _, mp = _sort_rows(m_key, m_pay)
    is_c = mp >= 0
    cs = torch.cumsum(is_c, dim=1)
    mpos = torch.arange(W + P, device=dev)[None, :]
    rank_t = mpos - (cs - 1)             # touts before this candidate entry
    row_off = torch.arange(B, device=dev)[:, None] * P
    tgt_c = torch.where(is_c, row_off + mp, B * P).reshape(-1)
    cnt_tout = torch.zeros(B * P + 1, dtype=torch.int64, device=dev)
    cnt_tout[tgt_c] = rank_t.expand(B, W + P).reshape(-1)
    cnt_tout = cnt_tout[: B * P].reshape(B, P)
    sums = torch.where(cand >= 0, cnt_label - cnt_tout, 0)

    best = sums.max(dim=1).values
    has_cand = (cand >= 0).any(dim=1)

    # ---- read tax error (closed form of the sticky abort) ------------------
    n_miss = (label == LABEL_MISS).sum(dim=1)
    col = torch.arange(L, device=dev)[None, :]
    bad_b = (codes > 3) & (col < lengths[:, None])
    early = (bad_b & (col <= (n_win - 2)[:, None])).sum(dim=1)
    late = (bad_b & (col >= (n_win - 1)[:, None])).any(dim=1).to(torch.int64)
    tax_err = n_miss + early + late
    tax_failed = tax_err >= err_bounds[:, 0]

    # ---- winner: LCA of all candidates achieving the best sum --------------
    is_best = (sums == best[:, None]) & (cand >= 0) & (best[:, None] > 0)

    if cfg.threshold > 1:
        # threshold promotion (see the JAX module docstring, item 6)
        rs_idx = torch.cummax(torch.where(run_start_m, s_idx, -1),
                              dim=1).values
        run_cnt = torch.where(run_end_m, s_idx - rs_idx + 1, 0)
        sn_e = s_node[:, None, :]
        tout_sn = s_tout[:, None, :]
        c_e2 = cand[:, :, None]
        anc_ok = ((sn_e >= 0) & (c_e2 >= 0) & (sn_e <= c_e2)
                  & (c_e2 < tout_sn))
        d_lab = torch.where(run_end_m & (s_node >= 0), s_depth, D)
        bp_off = (torch.arange(B, device=dev)[:, None, None] * P
                  + torch.arange(P, device=dev)[None, :, None])
        tgt_h = torch.where(anc_ok & (d_lab[:, None, :] < D),
                            bp_off * D + d_lab[:, None, :],
                            B * P * D).reshape(-1)
        hist = torch.zeros(B * P * D + 1, dtype=torch.int64,
                           device=dev).index_add_(
            0, tgt_h, run_cnt[:, None, :].expand(B, P, W).reshape(-1))[
            : B * P * D].reshape(B, P, D)
        suffix = torch.cumsum(hist.flip(2), dim=2).flip(2)
        suffix_pad = torch.cat(
            [suffix, torch.zeros((B, P, 1), dtype=torch.int64, device=dev)],
            dim=2)
        promo_depth = (suffix >= cfg.threshold).sum(dim=2) - 1
        promoted = torch.where(
            (cand >= 0) & (promo_depth >= 0),
            anc[cand.clamp(min=0), promo_depth.clamp(min=0)], -1)
        sum_at_promo = suffix_pad[:, :, 0] - suffix_pad.gather(
            2, promo_depth.clamp(min=0)[:, :, None] + 1)[:, :, 0]
        fold_nodes = promoted
    else:
        fold_nodes = cand

    # LCA of the selected set in one pair-LCA: LCA(min, max)
    sel = is_best & (fold_nodes >= 0)
    mn = torch.where(sel, fold_nodes, BIG).min(dim=1).values
    mx = torch.where(sel, fold_nodes, -1).max(dim=1).values
    any_null = (is_best & (fold_nodes < 0)).any(dim=1)
    pair = _lca_pair(anc, torch.where(mn == BIG, 0, mn).clamp(min=0),
                     mx.clamp(min=0))
    acc = torch.where(mx >= 0, torch.where(mn == mx, mx, pair), -1)

    classified = found & ~tax_failed & has_cand & ~any_null
    class_node = torch.where(classified, acc, -1)
    # a null class node drops the read (see JAX); tax-error-aborted reads
    # still return found
    out["found"] = found & (tax_failed | ~any_null)
    if cfg.threshold > 1:
        # argmax over an int cast: ties go to the first index, as in JAX
        first_best = torch.argmax(is_best.to(torch.int32), dim=1)
        rk = sum_at_promo.gather(1, first_best[:, None])[:, 0]
        read_kmers = torch.where(classified, rk, 0)
    else:
        read_kmers = torch.where(classified, best, 0)

    # ---- class error check (gates per-tax stats only) ----------------------
    class_err_c = n_win - read_kmers
    stats_ok = (class_err_c <= err_bounds[:, 1]) & (class_node >= 0)

    out["class_node"] = class_node
    out["read_kmers"] = read_kmers
    out["tax_err"] = tax_err
    out["stats_ok"] = stats_ok
    return out


# ---------------------------------------------------------------------------
# accumulating step — one device->host transfer per batch
# ---------------------------------------------------------------------------

def node_state_init(n_nodes: int, device: torch.device):
    """Initial per-node accumulator state (one leading [T] vector each)."""
    T = n_nodes
    z = lambda: torch.zeros(T, dtype=torch.int32, device=device)  # noqa: E731
    return {
        "kmers": z(),
        "contigs": z(),
        "contig_sq": z(),
        "reads1": z(),
        "mc_len": z(),
        "mc_enc": z(),
        "mc_bno": torch.full((T,), -1, dtype=torch.int32, device=device),
    }


def contig_sq_drain_every(B: int, W: int) -> int:
    """Batches between drains keeping the int32 contig^2 accumulator exact."""
    per_batch = B * W * W
    return max(1, (2**31 - 1) // max(per_batch, 1))


def fold_node_state(state, out, batch_no: int):
    """Fold one match_step output into the node accumulators (device)."""
    i32 = torch.int32
    new = {
        "kmers": (state["kmers"] + out["kmers"]).to(i32),
        "contigs": (state["contigs"] + out["contigs"]).to(i32),
        "contig_sq": (state["contig_sq"] + out["contig_sq"].sum(dim=0)).to(i32),
        "reads1": (state["reads1"] + out["reads1"]).to(i32),
    }
    # strict > keeps the earliest batch's achiever on ties
    better = out["max_contig"] > state["mc_len"]
    new["mc_len"] = torch.where(better, out["max_contig"], state["mc_len"]).to(i32)
    new["mc_enc"] = torch.where(better, out["argmax_enc"], state["mc_enc"]).to(i32)
    new["mc_bno"] = torch.where(better, batch_no, state["mc_bno"]).to(i32)
    return new


def per_read_layout(n_nodes: int, W: int, L: int):
    """Bit layout of the per-read result word(s) for a given batch shape.

    Returns (words, nbits, kbits, ebits): with words == 1 everything fits one
    int32 [B] vector (half the per-batch transfer) —
      [found(1) | stats_ok(1) | tax_err(ebits) | read_kmers(kbits) |
       class_node+1(nbits)];
    words == 3 is the wide fallback for long reads ([B, 3]: class_node;
    found|stats_ok|tax_err; read_kmers) — every field at full width, so
    classification-enabled long reads are never clamped (tax_err <= W + L
    < 2^30 for any feasible read length).
    Field bounds: read_kmers <= n_win <= W; tax_err <= n_win + #bad bases
    <= W + L; class_node in [-1, n_nodes)."""
    nbits = max(int(np.ceil(np.log2(n_nodes + 2))), 1)
    kbits = max(int(np.ceil(np.log2(W + 2))), 1)
    ebits = max(int(np.ceil(np.log2(W + L + 2))), 1)
    if 2 + ebits + kbits + nbits <= 31:
        return 1, nbits, kbits, ebits
    return 3, 0, 0, 0


def pack_per_read(out, n_nodes: int, W: int, L: int):
    words, nbits, kbits, ebits = per_read_layout(n_nodes, W, L)
    found = out["found"].to(torch.int64)
    stats_ok = out["stats_ok"].to(torch.int64)
    tax_err, read_kmers = out["tax_err"], out["read_kmers"]
    class_node = out["class_node"]
    if words == 1:
        w = ((found << (ebits + kbits + nbits + 1))
             | (stats_ok << (ebits + kbits + nbits))
             | ((tax_err & ((1 << ebits) - 1)) << (kbits + nbits))
             | ((read_kmers & ((1 << kbits) - 1)) << nbits)
             | ((class_node + 1) & ((1 << nbits) - 1)))
        return w.to(torch.int32)
    w1 = (found * -(1 << 31)) | (stats_ok << 30) | (tax_err & ((1 << 30) - 1))
    return torch.stack([class_node, w1, read_kmers], dim=1).to(torch.int32)


def unpack_per_read_np(pk: np.ndarray, n_nodes: int, W: int, L: int):
    """Host inverse of pack_per_read.

    Returns (class_node i64, found bool, stats_ok bool, tax_err i64,
    read_kmers i64)."""
    words, nbits, kbits, ebits = per_read_layout(n_nodes, W, L)
    if words == 1:
        w = pk.astype(np.int64)
        cls = (w & ((1 << nbits) - 1)) - 1
        read_kmers = (w >> nbits) & ((1 << kbits) - 1)
        tax_err = (w >> (kbits + nbits)) & ((1 << ebits) - 1)
        stats_ok = ((w >> (ebits + kbits + nbits)) & 1) != 0
        found = ((w >> (ebits + kbits + nbits + 1)) & 1) != 0
        return cls, found, stats_ok, tax_err, read_kmers
    cls = pk[:, 0].astype(np.int64)
    w1 = pk[:, 1].view(np.uint32)
    found = (w1 >> 31) != 0
    stats_ok = ((w1 >> 30) & 1) != 0
    tax_err = (w1 & ((1 << 30) - 1)).astype(np.int64)
    read_kmers = pk[:, 2].astype(np.int64)
    return cls, found, stats_ok, tax_err, read_kmers


def match_accum_step(cfg: MatchConfig, spec: TableSpec, n_nodes: int,
                     rows, vaux, anc, codes, lengths, err_bounds,
                     seen, counts, nstate, batch_no: int):
    """match_step + device-side accumulation; returns (per_read packed
    int32 (see per_read_layout), label or None, seen, counts, nstate)."""
    out = match_step(cfg, spec, n_nodes, rows, vaux, anc,
                     codes, lengths, err_bounds, seen, counts)
    nstate = fold_node_state(nstate, out, batch_no)
    B, L = codes.shape
    packed = pack_per_read(out, n_nodes, L - cfg.k + 1, L)
    label = out["label"] if cfg.return_labels else None
    return packed, label, out["seen"], out["counts"], nstate
