"""Vectorized canonical k-mer window computation (PyTorch port of
genestrip_tpu/ops/kmer.py).

The numpy helpers (`window_kmers_np`, `split_u64`, `merge_u64`) are copies
of the reference's. `window_kmers` computes every window of a padded batch
at once, as the JAX function does: the straight and reverse-complement
encodings are sums of k shifted slices of the 2-bit code array.

Device representation: the JAX function returns (hi, lo) uint32 halves.
PyTorch has no usable uint32 arithmetic on the CPU (no `>>` or `<`), so the
port builds each window's k-mer as one int64 (at most 62 bits) and returns
its halves as int64 tensors holding the same unsigned 32-bit values.
"""

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Host (numpy, uint64) — golden model + DB-build path
# ---------------------------------------------------------------------------

def _bitrev_groups_u64(x: np.ndarray) -> np.ndarray:
    """Reverse the order of the 32 2-bit groups of each uint64 (in place safe).

    Written with explicit out= buffers: the naive expression allocated six
    fresh W-sized temporaries per call (page-fault bound at DB-build sizes;
    measured 86 -> 52 ms per 4M elements)."""
    m2 = np.uint64(0x3333333333333333)
    m4 = np.uint64(0x0F0F0F0F0F0F0F0F)
    t = np.bitwise_and(x, m2)
    np.left_shift(t, np.uint64(2), out=t)
    u = np.right_shift(x, np.uint64(2))
    np.bitwise_and(u, m2, out=u)
    np.bitwise_or(t, u, out=t)
    np.bitwise_and(t, m4, out=u)
    np.left_shift(u, np.uint64(4), out=u)
    np.right_shift(t, np.uint64(4), out=t)
    np.bitwise_and(t, m4, out=t)
    np.bitwise_or(u, t, out=u)
    return u.byteswap()


def window_kmers_np(codes: np.ndarray, k: int):
    """All-window canonical k-mers of a 1-D code array (host side).

    Returns (canonical uint64 [W], valid bool [W]) with W = max(L - k + 1, 0).
    valid[i] is False iff window i contains a non-CGAT base.

    Implementation: 2-bit codes are packed into uint64 words (32 bases/word,
    base i at bit 2*(i%32) of word i//32); each window's 64-bit little-endian
    slice is two word fetches + a variable shift, from which the straight
    k-mer is a 2-bit-group reversal and the reverse complement a XOR — ~10
    vector ops total instead of the former k-iteration shifted-OR loop
    (ref semantics: core util/CGAT.java kMerToLongStraight/Reverse).
    """
    L = len(codes)
    W = max(L - k + 1, 0)
    if W == 0:
        return np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=bool)
    # pack pairwise in uint8 (2 bases -> 4 bits -> 1 byte = 4 bases), then
    # view the little-endian byte stream directly as uint64 words — no wide
    # temporary and no reduction
    n_words = (L + 31) // 32 + 1          # +1 pad word for q+1 fetches
    cpad = np.zeros(n_words * 32, np.uint8)
    np.bitwise_and(codes, 3, out=cpad[:L])
    b0 = cpad[0::2] | (cpad[1::2] << 2)
    b1 = b0[0::2] | (b0[1::2] << 4)
    words = b1.view(np.uint64)

    # index vectors via tile/repeat of the 32-periodic pattern (measured ~10x
    # cheaper than arange + mask/shift temporaries at this size)
    nq = (W + 31) >> 5
    q = np.repeat(np.arange(nq, dtype=np.intp), 32)[:W]
    r = np.tile(np.arange(0, 64, 2, dtype=np.uint64), nq)[:W]
    lo = words.take(q)
    lo >>= r
    # (w << 1) << (63 - r) == w << (64 - r), giving 0 at r == 0 without a where
    q += 1                                 # pad word guarantees q+1 in range
    hi = words.take(q)
    hi <<= np.uint64(1)
    np.subtract(np.uint64(63), r, out=r)
    hi <<= r
    v = lo
    v |= hi                                # base i+t at bits [2t, 2t+2)

    straight = _bitrev_groups_u64(v) >> np.uint64(64 - 2 * k)
    mask_2k = np.uint64((1 << (2 * k)) - 1)
    comp = np.uint64(0x5555555555555555) & mask_2k
    reverse = (v & mask_2k) ^ comp

    bad = codes > 3
    cc = np.zeros(L + 1, dtype=np.int32)
    np.cumsum(bad, out=cc[1:])
    valid = (cc[k:] - cc[:W]) == 0
    return np.maximum(straight, reverse), valid


def split_u64(x: np.ndarray):
    """Split uint64 keys into (hi, lo) uint32 arrays."""
    x = x.astype(np.uint64)
    return (x >> np.uint64(32)).astype(np.uint32), (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def merge_u64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    return (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)


# ---------------------------------------------------------------------------
# Device (torch, int64 halves)
# ---------------------------------------------------------------------------

def window_kmers(codes: torch.Tensor, lengths: torch.Tensor, k: int):
    """All-window canonical k-mers for a padded batch of sequences.

    Args:
      codes: [B, L] uint8 2-bit codes, BAD (255) for non-CGAT bases and padding.
      lengths: [B] integer true sequence lengths.
      k: k-mer length (1..31).

    Returns:
      hi, lo: [B, W] int64 canonical k-mer halves, each in [0, 2^32) — the
        bit patterns of the JAX function's uint32 halves (garbage where not
        clean, the same garbage).
      clean:  [B, W] bool — window has no bad base.
      exists: [B, W] bool — window lies within the read (i < len - k + 1).
    """
    B, L = codes.shape
    W = L - k + 1
    if W < 1:
        raise ValueError("padded length must be >= k")
    c = codes.to(torch.int64) & 3
    straight = torch.zeros((B, W), dtype=torch.int64, device=codes.device)
    reverse = torch.zeros_like(straight)
    for j in range(k):
        cj = c[:, j:j + W]
        straight |= cj << (2 * (k - 1 - j))
        reverse |= (cj ^ 1) << (2 * j)
    # both are < 2^62, so the signed max is the unsigned max of the JAX code
    canon = torch.maximum(straight, reverse)
    hi = canon >> 32
    lo = canon & 0xFFFFFFFF
    bad = (codes > 3).to(torch.int64)
    cc = torch.zeros((B, L + 1), dtype=torch.int64, device=codes.device)
    cc[:, 1:] = torch.cumsum(bad, dim=1)
    clean = (cc[:, k:] - cc[:, :W]) == 0
    pos = torch.arange(W, device=codes.device)[None, :]
    exists = pos < (lengths.to(torch.int64)[:, None] - (k - 1))
    return hi, lo, clean, exists
