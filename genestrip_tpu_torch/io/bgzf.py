"""BGZF (blocked gzip) support: parallel decompression of bgzip'd inputs.

Most real-world fastq.gz in bioinformatics pipelines (SRA deliveries,
htslib/samtools outputs) are BGZF: a sequence of independent <=64 KiB gzip
members, each carrying its compressed size in a 'BC' extra subfield. That
framing makes the inflate parallelizable — the host input pipeline's only
hard single-stream ceiling (~1.2M reads/s of plain-gzip inflate measured,
bench.py) disappears for such files.

The reference has no equivalent (it reads every gzip serially through
java.util.zip — core io/StreamProvider.java:44-67); this is a TPU-era
addition: the device consumes tens of millions of reads/s, so the host feed
needs every core it can use.

Design: a consumer-side splitter parses block headers (cheap, sequential)
and submits whole members to a small thread pool — zlib releases the GIL,
so inflate scales across cores — while results are consumed in order
through an io.RawIOBase, giving read()/readline() via io.BufferedReader.
Non-BGZF gzip files are untouched (detection via the fixed BC subfield in
the first member header; plain GzipFile path otherwise —
io/streams.py StreamingResource.open).
"""

from __future__ import annotations

import io
import struct
import zlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor

_MAGIC = b"\x1f\x8b\x08\x04"     # gzip + FEXTRA — required for BGZF
_EOF_BLOCK = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


def is_bgzf_header(head: bytes) -> bool:
    """True when `head` (>= 18 bytes of a stream) starts a BGZF member."""
    if len(head) < 18 or head[:4] != _MAGIC:
        return False
    xlen = head[10] | (head[11] << 8)
    if xlen < 6 or len(head) < 12 + 6:
        return False
    # scan the extra subfields we can see for 'BC' with SLEN == 2
    extra = head[12: 12 + min(xlen, len(head) - 12)]
    off = 0
    while off + 4 <= len(extra):
        si1, si2, slen = extra[off], extra[off + 1], \
            extra[off + 2] | (extra[off + 3] << 8)
        if si1 == 0x42 and si2 == 0x43 and slen == 2:
            return True
        off += 4 + slen
    return False


def _bc_bsize(header: bytes, extra: bytes) -> int:
    """BSIZE (total member size - 1) from the BC subfield; -1 if absent."""
    off = 0
    while off + 4 <= len(extra):
        si1, si2, slen = extra[off], extra[off + 1], \
            extra[off + 2] | (extra[off + 3] << 8)
        if si1 == 0x42 and si2 == 0x43 and slen == 2:
            return extra[off + 4] | (extra[off + 5] << 8)
        off += 4 + slen
    return -1


class _BgzfRaw(io.RawIOBase):
    """Raw stream of inflated BGZF bytes, blocks decompressed by a pool.

    Members are submitted in groups of `group` (~1 MiB of compressed data
    per future) — per-member futures measured ~10% slower from Python
    overhead at the 64 KiB bgzip block size."""

    def __init__(self, stream, threads: int = 3, prefetch: int = 16,
                 group: int = 16):
        self._stream = stream
        self._exe = ThreadPoolExecutor(threads)
        self._futures: deque = deque()
        self._prefetch = prefetch
        self._group = group
        self._buf = b""
        self._off = 0
        self._raw_eof = False

    def readable(self):
        return True

    def _read_member(self) -> bytes | None:
        """Next whole compressed member off the underlying stream."""
        head = self._stream.read(12)
        if not head:
            return None
        if len(head) < 12 or head[:4] != _MAGIC:
            raise OSError("corrupt BGZF stream: bad member header")
        xlen = head[10] | (head[11] << 8)
        extra = self._stream.read(xlen)
        bsize = _bc_bsize(head, extra)
        if bsize < 0:
            raise OSError("corrupt BGZF stream: BC subfield missing")
        rest = self._stream.read(bsize + 1 - 12 - xlen)
        return head + extra + rest

    @staticmethod
    def _inflate_group(members):
        # wbits=47: zlib parses each full member incl. header + CRC check
        return b"".join(zlib.decompress(m, 47) for m in members)

    def _fill(self):
        while len(self._futures) < self._prefetch and not self._raw_eof:
            ms = []
            for _ in range(self._group):
                m = self._read_member()
                if m is None:
                    self._raw_eof = True
                    break
                ms.append(m)
            if ms:
                self._futures.append(
                    self._exe.submit(self._inflate_group, ms))

    def readinto(self, b):
        while self._off >= len(self._buf):
            self._fill()
            if not self._futures:
                return 0
            self._buf = self._futures.popleft().result()
            self._off = 0
            self._fill()      # keep the pool primed
            # empty members (the EOF marker) just loop
        n = min(len(b), len(self._buf) - self._off)
        b[:n] = self._buf[self._off: self._off + n]
        self._off += n
        return n

    def close(self):
        try:
            self._exe.shutdown(wait=False, cancel_futures=True)
        finally:
            super().close()


def open_bgzf(stream, threads: int = 3) -> io.BufferedReader:
    """Buffered reader of inflated bytes over a BGZF byte stream."""
    return io.BufferedReader(_BgzfRaw(stream, threads=threads),
                             buffer_size=1 << 20)


class BgzfWriter:
    """Writes BGZF: independent gzip members of <= `block` payload bytes,
    each framed with the BC subfield, terminated by the standard EOF
    marker. Output is plain valid gzip for any consumer."""

    def __init__(self, fileobj, compresslevel: int = 5, block: int = 65280):
        self._f = fileobj
        self._level = compresslevel
        self._block = block
        self._pend = bytearray()

    def write(self, data: bytes) -> int:
        self._pend += data
        while len(self._pend) >= self._block:
            self._emit(bytes(self._pend[: self._block]))
            del self._pend[: self._block]
        return len(data)

    def _emit(self, payload: bytes) -> None:
        co = zlib.compressobj(self._level, zlib.DEFLATED, -15)
        cdata = co.compress(payload) + co.flush()
        bsize = 12 + 6 + len(cdata) + 8 - 1
        if bsize >= 1 << 16:
            raise ValueError("BGZF block too large; lower `block`")
        self._f.write(
            _MAGIC + b"\x00\x00\x00\x00\x00\xff"      # mtime, XFL, OS
            + struct.pack("<H", 6)                     # XLEN
            + b"BC" + struct.pack("<HH", 2, bsize)
            + cdata
            + struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF,
                          len(payload) & 0xFFFFFFFF))

    def close(self) -> None:
        if self._pend:
            self._emit(bytes(self._pend))
            self._pend.clear()
        self._f.write(_EOF_BLOCK)
        self._f.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
