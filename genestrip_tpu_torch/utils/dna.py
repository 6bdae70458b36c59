"""DNA byte-level codec tables and host-side helpers.

Encoding follows the reference semantics (ref: core util/CGAT.java:60-83):
2-bit codes C=0, G=1, A=2, T=3; the code of a base's complement is its own
code XOR 1 (C<->G, A<->T). The canonical ("standard") k-mer of a window is
the unsigned max of the straight encoding and the reverse-complement
encoding (ref: CGAT.java:145-147). k <= 31, so k-mers fit in 62 bits and
signed/unsigned comparison coincide.
"""

import numpy as np

# Code for each input byte; 255 marks a non-CGAT byte. Lowercase acceptance is
# a config decision made by the caller (ref: ConfigParams.md `lowerCaseBases`),
# so two tables are provided.
BAD = 255

CODE_TABLE = np.full(256, BAD, dtype=np.uint8)
for _b, _c in zip(b"CGAT", (0, 1, 2, 3)):
    CODE_TABLE[_b] = _c

CODE_TABLE_LOWER = CODE_TABLE.copy()
for _b, _c in zip(b"cgat", (0, 1, 2, 3)):
    CODE_TABLE_LOWER[_b] = _c

# code -> base letter (ref: CGAT.java DECODE_TABLE)
DECODE_TABLE = np.frombuffer(b"CGAT", dtype=np.uint8)

COMPLEMENT_TABLE = np.full(256, BAD, dtype=np.uint8)
for _a, _b in zip(b"CGAT", b"GCTA"):
    COMPLEMENT_TABLE[_a] = _b


def seq_to_codes(seq: bytes | np.ndarray, lowercase: bool = True) -> np.ndarray:
    """Encode a byte sequence into 2-bit codes (uint8), BAD for non-CGAT."""
    arr = np.frombuffer(seq, dtype=np.uint8) if isinstance(seq, (bytes, bytearray)) else seq
    table = CODE_TABLE_LOWER if lowercase else CODE_TABLE
    return table[arr]


def codes_to_seq(codes: np.ndarray) -> bytes:
    """Decode 2-bit codes back into an ASCII base string."""
    return DECODE_TABLE[codes].tobytes()


def kmer_to_u64_straight(codes: np.ndarray) -> int:
    """Straight encoding of one window of codes (host-side reference).

    ref: CGAT.kMerToLongStraight (core util/CGAT.java:159-180).
    Returns -1 (as python int) if a BAD code is present.
    """
    if np.any(codes == BAD):
        return -1
    res = 0
    for c in codes:
        res = (res << 2) | int(c)
    return res


def kmer_to_u64_reverse(codes: np.ndarray) -> int:
    """Reverse-complement encoding of one window (host-side reference).

    ref: CGAT.kMerToLongReverse (core util/CGAT.java:245-265).
    """
    if np.any(codes == BAD):
        return -1
    res = 0
    for c in codes[::-1]:
        res = (res << 2) | (int(c) ^ 1)
    return res


def canonical_u64(straight: int, reverse: int) -> int:
    """Canonical k-mer = max of the two encodings (ref: CGAT.java:145-147)."""
    return straight if straight > reverse else reverse


def u64_to_seq(kmer: int, k: int) -> bytes:
    """Decode a straight k-mer encoding to bases (ref: CGAT.longToKMerStraight)."""
    out = bytearray(k)
    for i in range(k - 1, -1, -1):
        out[i] = DECODE_TABLE[kmer & 3]
        kmer >>= 2
    return bytes(out)
