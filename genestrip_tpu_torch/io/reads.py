"""Fastq/fasta read parsing into padded, 2-bit-packed device batches.

Reference equivalent: core fastq/AbstractFastqReader.java — its producer
thread parses reads into pooled byte buffers consumed by matcher threads
(ref: doReadFastq:288-368, doReadFasta:375-438). The TPU pipeline instead
packs reads into fixed-shape batches:

  codes   [B, L] uint8 (2-bit code, BAD for non-CGAT/padding)
  lengths [B]    int32
plus per-read descriptors and raw line spans for output rewriting.

Two parsers share the BatchPacker:

* `parse_fastq` — robust line-at-a-time parser handling multi-line reads
  and quality exactly like the reference (doReadFastq:299-341).
* `parse_fastq_blocks` — the fast path: reads MB-sized blocks, finds record
  boundaries with numpy (no per-read Python), and hands whole span arrays to
  the packer. It validates the common strict 4-line layout per block and
  falls back to the robust parser mid-stream on any violation (multi-line
  records, blank lines), so behavior is identical for any input. Measured
  >20x the per-read parser — the host feed must outrun the device pipeline
  (ref producer/consumer contract: AbstractFastqReader.java:88-185).

Padded length L is bucketed to bound the number of distinct compiled shapes.
"""

from __future__ import annotations

import io
import queue
import threading
from dataclasses import dataclass

import numpy as np

from genestrip_tpu_torch.utils.dna import BAD, CODE_TABLE, CODE_TABLE_LOWER


class _Rows:
    """Lazy per-read byte access over heterogeneous segments.

    Each segment is either ("b", list_of_bytes) or ("s", buf, starts, ends)
    — span triples referencing a shared block buffer. Materializes bytes
    only on access (kraken/filtered-fastq writers), so the match hot loop
    never touches per-read Python objects.
    """

    __slots__ = ("_segs", "_cum")

    def __init__(self, segs):
        self._segs = segs
        cum = [0]
        for seg in segs:
            cum.append(cum[-1] + (len(seg[1]) if seg[0] == "b" else len(seg[2])))
        self._cum = cum

    def __len__(self):
        return self._cum[-1]

    def __getitem__(self, i):
        if i < 0:
            i += len(self)
        lo, hi = 0, len(self._segs)
        while lo + 1 < hi:                      # bisect over <=2 segs usually
            mid = (lo + hi) // 2
            if self._cum[mid] <= i:
                lo = mid
            else:
                hi = mid
        seg = self._segs[lo]
        j = i - self._cum[lo]
        if seg[0] == "b":
            return seg[1][j]
        _, buf, starts, ends = seg
        return buf[starts[j]:ends[j]].tobytes()

    def __iter__(self):
        for seg in self._segs:
            if seg[0] == "b":
                yield from seg[1]
            else:
                _, buf, starts, ends = seg
                for s, e in zip(starts, ends):
                    yield buf[s:e].tobytes()


@dataclass
class ReadBatch:
    codes: np.ndarray            # [B, L] uint8
    lengths: np.ndarray          # [B] int32
    descriptors: "_Rows | list"  # raw descriptor lines incl. leading '@'
    seqs: "_Rows | list"         # raw sequence bytes (for rewriting output)
    probs: "_Rows | list | None" # quality strings, or None
    read_no0: int                # read number of the first read in this batch
    is_long: bool = False        # singleton batch holding one long read

    @property
    def n(self) -> int:
        return len(self.lengths)


def _bucket_len(n: int, min_len: int = 64) -> int:
    """Round padded length up a geometric ladder (1.25x steps) to bound
    the number of distinct XLA shapes."""
    L = min_len
    while L < n:
        L = max(L + 64, int(L * 1.25) // 64 * 64)
    return L


class BatchPacker:
    """Accumulates parsed reads and emits packed ReadBatches.

    Reads arrive either one at a time (`add`, robust parsers) or as whole
    span arrays over a block buffer (`add_block`, fast parser); both paths
    preserve arrival order. Reads longer than `long_threshold` bases are
    emitted as singleton batches flagged `is_long`, cutting the current
    batch first so emission order equals read order (the matcher routes
    them through the chunked long-read path — SURVEY.md §5.7; ref matchlr,
    Goals.md:15)."""

    def __init__(self, batch_size: int, lowercase: bool = True,
                 with_probs: bool = False, long_threshold: int | None = None):
        self.batch_size = batch_size
        self.table = CODE_TABLE_LOWER if lowercase else CODE_TABLE
        # bytes.translate runs the 256-entry LUT ~5.5x faster than a numpy
        # uint8 gather (measured 860 MB/s vs 150 MB/s on this host)
        self.table_bytes = self.table.tobytes()
        self.with_probs = with_probs
        self.long_threshold = long_threshold
        # pending segments: ("b", descs, seqs, probs, lens) byte lists or
        # ("s", buf, spans[6xN]) span arrays; _count = total pending reads
        self._segs: list = []
        self._count = 0
        self._ready: list[ReadBatch] = []
        self._read_no = 0

    def reset_read_no(self):
        self._read_no = 0

    # ---- single-read path (robust parsers) -------------------------------

    def add(self, desc: bytes, seq: bytes, prob: bytes | None = None):
        if self.long_threshold is not None and len(seq) > self.long_threshold:
            while self._count:
                self._ready.append(self._pack())
            self._append_read(desc, seq, prob)
            self._ready.append(self._pack(is_long=True))
            return
        self._append_read(desc, seq, prob)
        if self._count >= self.batch_size:
            self._ready.append(self._pack())

    def _append_read(self, desc, seq, prob):
        if self._segs and self._segs[-1][0] == "b":
            seg = self._segs[-1]
        else:
            seg = ("b", [], [], [])
            self._segs.append(seg)
        seg[1].append(desc)
        seg[2].append(seq)
        seg[3].append(prob or b"")
        self._count += 1

    # ---- block path (fast parser) ----------------------------------------

    def add_block(self, buf: np.ndarray, d_s, d_e, s_s, s_e, q_s, q_e,
                  mapped: np.ndarray | None = None):
        """Bulk-append records given as span arrays over a block buffer.

        mapped: optional pre-translated 2-bit view of buf (the fast parser
        computes it via bytes.translate on the raw block)."""
        n = len(d_s)
        if n == 0:
            return
        if self.long_threshold is not None:
            lens = s_e - s_s
            long_idx = np.flatnonzero(lens > self.long_threshold)
        else:
            long_idx = ()
        # 2-bit-map the whole block once; batches then need a single gather
        if mapped is None:
            mapped = self.table[buf]
        if len(long_idx) == 0:
            self._segs.append(("s", buf, (d_s, d_e, s_s, s_e, q_s, q_e), mapped))
            self._count += n
        else:
            prev = 0
            for li in long_idx:
                if li > prev:
                    self._segs.append(("s", buf, tuple(
                        a[prev:li] for a in (d_s, d_e, s_s, s_e, q_s, q_e)),
                        mapped))
                    self._count += li - prev
                while self._count:
                    self._ready.append(self._pack())
                self._append_read(buf[d_s[li]:d_e[li]].tobytes(),
                                  buf[s_s[li]:s_e[li]].tobytes(),
                                  buf[q_s[li]:q_e[li]].tobytes()
                                  if self.with_probs else None)
                self._ready.append(self._pack(is_long=True))
                prev = li + 1
            if prev < n:
                self._segs.append(("s", buf, tuple(
                    a[prev:] for a in (d_s, d_e, s_s, s_e, q_s, q_e)), mapped))
                self._count += n - prev
        while self._count >= self.batch_size:
            self._ready.append(self._pack())

    # ---- emission --------------------------------------------------------

    def __len__(self):
        return self._count

    def full(self) -> bool:
        return bool(self._ready) or self._count >= self.batch_size

    def flush(self) -> ReadBatch | None:
        if self._ready:
            return self._ready.pop(0)
        if not self._count:
            return None
        return self._pack()

    def _take(self, n: int):
        """Split the first n reads off the pending segments."""
        taken = []
        while n > 0:
            seg = self._segs[0]
            sz = len(seg[1]) if seg[0] == "b" else len(seg[2][0])
            if sz <= n:
                taken.append(seg)
                self._segs.pop(0)
                n -= sz
            else:
                if seg[0] == "b":
                    taken.append(("b", seg[1][:n], seg[2][:n], seg[3][:n]))
                    self._segs[0] = ("b", seg[1][n:], seg[2][n:], seg[3][n:])
                else:
                    _, buf, spans, mapped = seg
                    taken.append(("s", buf, tuple(a[:n] for a in spans), mapped))
                    self._segs[0] = ("s", buf,
                                     tuple(a[n:] for a in spans), mapped)
                n = 0
        return taken

    def _pack(self, is_long: bool = False) -> ReadBatch:
        B = min(self._count, self.batch_size) if not is_long else 1
        if is_long:
            B = len(self._segs[-1][1]) if self._segs[-1][0] == "b" else 1
            taken = [self._segs.pop()]
            self._count -= 1
        else:
            taken = self._take(B)
            self._count -= B

        lengths = np.empty(B, np.int32)
        off = 0
        for seg in taken:
            if seg[0] == "b":
                for s in seg[2]:
                    lengths[off] = len(s)
                    off += 1
            else:
                spans = seg[2]
                k = len(spans[2])
                lengths[off:off + k] = (spans[3] - spans[2]).astype(np.int32)
                off += k
        L = _bucket_len(int(lengths.max(initial=1)))
        codes = np.full((B, L), BAD, dtype=np.uint8)
        off = 0
        for seg in taken:
            if seg[0] == "b":
                seqs = seg[2]
                if seqs:
                    lens = lengths[off:off + len(seqs)].astype(np.int64)
                    flat = np.frombuffer(
                        b"".join(seqs).translate(self.table_bytes), np.uint8)
                    rows = np.repeat(np.arange(off, off + len(seqs)), lens)
                    cum = np.zeros(len(seqs) + 1, np.int64)
                    np.cumsum(lens, out=cum[1:])
                    cols = np.arange(cum[-1]) - np.repeat(cum[:-1], lens)
                    codes[rows, cols] = flat
                    off += len(seqs)
            else:
                # padded 2-D fetch from the pre-mapped block. Uniform-record
                # fast path: when all starts are equally strided (fixed-width
                # descriptors + uniform read length, the common fastq shape)
                # an as_strided view turns the fetch into one memcpy
                # (measured 5.7 ms vs 34 ms np.take vs 73-145 ms fancy
                # indexing per 131k x 192 at this host).
                _, buf, spans, mapped = seg
                s_s, s_e = spans[2], spans[3]
                k = len(s_s)
                lens = (s_e - s_s).astype(np.int32)
                if k > 1:
                    stride = int(s_s[1] - s_s[0])
                    uniform = (stride > 0
                               and int(s_s[-1] - s_s[0]) == stride * (k - 1)
                               and bool((np.diff(s_s) == stride).all())
                               and int(s_s[0]) + stride * (k - 1) + L
                               <= len(mapped))
                else:
                    uniform = False
                block = codes[off:off + k]
                if uniform:
                    from numpy.lib.stride_tricks import as_strided
                    # strided copy straight into the batch buffer (one copy,
                    # no intermediate ascontiguousarray allocation)
                    block[:] = as_strided(
                        mapped[int(s_s[0]):], shape=(k, L),
                        strides=(stride, 1))
                else:
                    col64 = np.arange(L, dtype=np.int64)
                    src = s_s[:, None] + col64[None, :]
                    np.take(mapped, src, mode="clip", out=block)
                col = np.arange(L, dtype=np.int32)
                block[col[None, :] >= lens[:, None]] = BAD
                off += k

        desc_segs, seq_segs, prob_segs = [], [], []
        for seg in taken:
            if seg[0] == "b":
                desc_segs.append(("b", seg[1]))
                seq_segs.append(("b", seg[2]))
                prob_segs.append(("b", seg[3]))
            else:
                buf, spans = seg[1], seg[2]
                desc_segs.append(("s", buf, spans[0], spans[1]))
                seq_segs.append(("s", buf, spans[2], spans[3]))
                prob_segs.append(("s", buf, spans[4], spans[5]))
        batch = ReadBatch(codes, lengths, _Rows(desc_segs), _Rows(seq_segs),
                          _Rows(prob_segs) if self.with_probs else None,
                          self._read_no, is_long=is_long)
        self._read_no += B
        return batch


def parse_fastq(stream, packer: BatchPacker):
    """Parse fastq from a binary stream, yielding ReadBatches (robust path).

    Sequence lines are joined until a line starting with '+'
    (ref: AbstractFastqReader.doReadFastq:299-307); quality lines are read
    until their total length reaches the sequence length (:318-341).
    """
    readline = stream.readline
    while True:
        desc = readline()
        if not desc:
            break
        desc = desc.rstrip(b"\r\n")
        if not desc:
            continue
        seq_parts = []
        seq_len = 0
        while True:
            line = readline()
            if not line or line.startswith(b"+"):
                break
            line = line.rstrip(b"\r\n")
            seq_parts.append(line)
            seq_len += len(line)
        seq = b"".join(seq_parts)
        prob_parts = []
        prob_len = 0
        while prob_len < seq_len:
            line = readline()
            if not line:
                break
            line = line.rstrip(b"\r\n")
            prob_parts.append(line)
            prob_len += len(line)
        packer.add(desc, seq, b"".join(prob_parts) if packer.with_probs else None)
        while packer.full():
            yield packer.flush()
    while True:
        b = packer.flush()
        if b is None:
            break
        yield b


class _Chain:
    """readline() over a bytes prefix followed by the rest of a stream."""

    def __init__(self, data: bytes, stream):
        self._buf = io.BytesIO(data)
        self._stream = stream

    def readline(self):
        line = self._buf.readline()
        if line.endswith(b"\n"):
            return line
        return line + self._stream.readline()


_AT, _PLUS = ord("@"), ord("+")


def parse_fastq_blocks(stream, packer: BatchPacker, block_size: int = 1 << 22):
    """Block-vectorized fastq parser (see module docstring).

    Validates the strict 4-line layout per block; any violation (multi-line
    records, blank lines, truncated tail) reroutes the unconsumed bytes plus
    the remaining stream through the robust `parse_fastq` — output is
    identical for every well-formed input either way.
    """
    carry = b""
    while True:
        chunk = stream.read(block_size)
        if not chunk:
            break
        data = carry + chunk if carry else chunk
        arr = np.frombuffer(data, np.uint8)
        nl = np.flatnonzero(arr == 10)
        nrec = len(nl) >> 2
        if nrec == 0:
            carry = data
            continue
        sub_nl = nl[: 4 * nrec]
        end_off = int(sub_nl[-1]) + 1
        carry = data[end_off:]
        starts = np.empty(4 * nrec, np.int64)
        starts[0] = 0
        starts[1:] = sub_nl[:-1] + 1
        ends = sub_nl - (arr[np.maximum(sub_nl - 1, 0)] == 13)
        d_s, s_s, p_s, q_s = starts[0::4], starts[1::4], starts[2::4], starts[3::4]
        d_e, s_e, p_e, q_e = ends[0::4], ends[1::4], ends[2::4], ends[3::4]
        ok = (bool((arr[d_s] == _AT).all())
              and bool((arr[p_s] == _PLUS).all())
              and bool(((s_e - s_s) == (q_e - q_s)).all())
              and bool((s_e > s_s).all()))
        if not ok:
            yield from parse_fastq(_Chain(data, stream), packer)
            return
        packer.add_block(arr, d_s, d_e, s_s, s_e, q_s, q_e,
                         mapped=np.frombuffer(
                             data.translate(packer.table_bytes), np.uint8))
        while packer.full():
            yield packer.flush()
    if carry:
        yield from parse_fastq(io.BytesIO(carry), packer)
        return
    while True:
        b = packer.flush()
        if b is None:
            break
        yield b


def parse_fasta_as_reads(stream, packer: BatchPacker):
    """Parse fasta from a binary stream as reads, yielding ReadBatches.

    Descriptors get their '>' replaced by '@' (ref: doReadFasta:380).
    """
    readline = stream.readline
    desc = None
    seq_parts: list[bytes] = []
    while True:
        line = readline()
        if not line:
            break
        if line.startswith(b">"):
            if desc is not None:
                packer.add(desc, b"".join(seq_parts))
                while packer.full():
                    yield packer.flush()
            desc = b"@" + line[1:].rstrip(b"\r\n")
            seq_parts = []
        elif desc is not None:
            seq_parts.append(line.rstrip(b"\r\n"))
    if desc is not None:
        packer.add(desc, b"".join(seq_parts))
    while True:
        b = packer.flush()
        if b is None:
            break
        yield b


def parse_reads(stream, packer: BatchPacker, fasta: bool,
                block: bool = True):
    if fasta:
        return parse_fasta_as_reads(stream, packer)
    return (parse_fastq_blocks if block else parse_fastq)(stream, packer)


def batch_feeder(gen, prefetch: int = 4):
    """Runs a ReadBatch generator on a worker thread with a bounded prefetch
    queue — the host parse/pack overlaps the device steps (the TPU analog of
    the reference's producer thread, AbstractFastqReader.java:88-118).
    Exceptions propagate to the consumer."""
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    _END = object()

    def run():
        try:
            for b in gen:
                q.put(b)
            q.put(_END)
        except BaseException as e:      # noqa: BLE001 — reraised on consumer
            q.put(e)

    threading.Thread(target=run, daemon=True).start()
    while True:
        item = q.get()
        if item is _END:
            return
        if isinstance(item, BaseException):
            raise item
        yield item
