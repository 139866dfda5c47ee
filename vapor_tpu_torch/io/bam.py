"""Native BAM/BGZF access — no samtools, no pysam.

The reference spawns ``samtools view bam chrom:start-end`` per event
(Simple_function.pyx:339-354).  We decode BGZF+BAM directly: BGZF is a
series of gzip members whose FEXTRA carries a ``BC`` subfield with the
compressed block size; BAM is a little-endian binary record stream.

Region queries reproduce htslib overlap semantics for coordinate-sorted
files: ``chrom:S-E`` (1-based inclusive) returns records with
``pos0 < E and endpos0 > S-1`` where ``endpos0`` is POS plus the
reference-consuming CIGAR length — in file order, which for a sorted BAM
is exactly the order ``samtools view`` emits.

The read-gather layer (io/reads.py) prefers the ``.bai``-driven random
-access path (io/bai.py, ``IndexedBam``) when an index is present.
Index-less files go through ``BamReader``, which inflates and queries
with the C++ codec (native/bamcodec.cpp, built at first use) and
decodes in pure Python when the codec is unavailable; the pure-Python
decode is also the differential baseline of the codec's tests.
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, Iterator, List, Tuple

import numpy as np

from ..utils import trace
from .cigar import encode_cigar, ref_length, render_cigar

BAM_MAGIC = b"BAM\x01"
SEQ_NIBBLE = "=ACMGRSVTWYHKDBN"
# a packed byte's two bases as one little-endian uint16: high nibble first
_NIBBLE_CODES = np.frombuffer(SEQ_NIBBLE.encode("ascii"), np.uint8)
_SEQ_PAIRS = (_NIBBLE_CODES[np.arange(256) >> 4].astype("<u2") |
              _NIBBLE_CODES[np.arange(256) & 0xF].astype("<u2") << 8)

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


class BamRecord:
    """One alignment.  The CIGAR stays as BAM stores it, uint32 words
    (``words``); a record parsed from a BAM (``_parse_record``) holds
    its buffer and decodes name, bases and quality only when they are
    read.  Built from text, as the simulators and the native codec's
    queries build it, it encodes its CIGAR once."""

    __slots__ = ("flag", "ref_id", "pos0", "mapq", "words", "l_seq",
                 "_name", "_seq", "_qual", "_buf", "_p_name", "_l_name",
                 "_p_seq")

    def __init__(self, name: str, flag: int, ref_id: int, pos0: int,
                 mapq: int, cigar: str, seq: str, qual: bytes):
        self.flag, self.ref_id, self.pos0, self.mapq = \
            flag, ref_id, pos0, mapq
        self.words = encode_cigar(cigar)
        self.l_seq = len(seq)
        self._name, self._seq, self._qual = name, seq, qual
        self._buf = None

    @property
    def name(self) -> str:
        if self._buf is None:
            return self._name
        p = self._p_name
        return self._buf[p:p + self._l_name - 1].decode("ascii")

    @property
    def cigar(self) -> str:
        """Text form, e.g. "10S90M2D100M" ("*" for none)."""
        return render_cigar(self.words)

    @property
    def seq(self) -> str:
        return self.bases(0, self.l_seq)

    @property
    def qual(self) -> bytes:
        if self._buf is None:
            return self._qual
        p = self._p_seq + (self.l_seq + 1) // 2
        return self._buf[p:p + self.l_seq]

    def bases(self, start: int, stop: int) -> str:
        """Bases [start, stop), 0 <= start <= stop <= l_seq."""
        if self._buf is None:
            return self._seq[start:stop]
        if start >= stop:
            return ""
        trace.count("reads.bases_decoded", stop - start)
        lo = start >> 1
        packed = np.frombuffer(self._buf, np.uint8,
                               count=((stop + 1) >> 1) - lo,
                               offset=self._p_seq + lo)
        pairs = _SEQ_PAIRS[packed].tobytes()
        return pairs[start & 1:(start & 1) + stop - start].decode("ascii")

    @property
    def end_pos0(self) -> int:
        """POS plus the reference bases the alignment consumes."""
        return self.pos0 + ref_length(self.words)


def _bgzf_blocks(data: bytes) -> Iterator[bytes]:
    """Yield decompressed payloads of successive BGZF blocks."""
    pos = 0
    n = len(data)
    while pos < n:
        if data[pos:pos + 2] != b"\x1f\x8b":
            raise ValueError(f"bad BGZF magic at offset {pos}")
        xlen = struct.unpack_from("<H", data, pos + 10)[0]
        extra = data[pos + 12: pos + 12 + xlen]
        bsize = None
        e = 0
        while e + 4 <= len(extra):
            si1, si2, slen = extra[e], extra[e + 1], struct.unpack_from(
                "<H", extra, e + 2)[0]
            if si1 == 0x42 and si2 == 0x43 and slen == 2:
                bsize = struct.unpack_from("<H", extra, e + 4)[0] + 1
            e += 4 + slen
        if bsize is None:
            raise ValueError("gzip member without BGZF BC subfield")
        cdata = data[pos + 12 + xlen: pos + bsize - 8]
        payload = zlib.decompress(cdata, wbits=-15)
        if payload:
            yield payload
        pos += bsize


def _decompress_bgzf(path: str) -> bytes:
    with open(path, "rb") as fh:
        raw = fh.read()
    return b"".join(_bgzf_blocks(raw))


class BamReader:
    """Whole-file BAM decoder with region iteration.

    Inflates and queries with the native codec (vapor_tpu_torch/native)
    unless it is unavailable or ``native`` is False, and with the
    pure-Python decoder otherwise; ``decoder`` says which one it used:
    "native" or "python"."""

    def __init__(self, path: str, native: bool = True):
        self.path = path
        self._native = None
        data = None
        if native:
            from .. import native as native_mod
            with open(path, "rb") as fh:
                data = native_mod.bgzf_decompress(fh.read())
            if data is not None:
                self._native = native_mod
        if data is None:
            data = _decompress_bgzf(path)
        self.decoder = "python" if self._native is None else "native"
        if data[:4] != BAM_MAGIC:
            raise ValueError(f"{path}: not a BAM file")
        l_text = struct.unpack_from("<i", data, 4)[0]
        off = 8 + l_text
        n_ref = struct.unpack_from("<i", data, off)[0]
        off += 4
        self.references: List[str] = []
        self.lengths: List[int] = []
        for _ in range(n_ref):
            l_name = struct.unpack_from("<i", data, off)[0]
            name = data[off + 4: off + 4 + l_name - 1].decode("ascii")
            l_ref = struct.unpack_from("<i", data, off + 4 + l_name)[0]
            self.references.append(name)
            self.lengths.append(l_ref)
            off += 8 + l_name
        self._ref_ids: Dict[str, int] = {
            name: i for i, name in enumerate(self.references)}
        self._data = data
        self._records_start = off

    def __iter__(self) -> Iterator[BamRecord]:
        data = self._data
        off = self._records_start
        n = len(data)
        while off + 4 <= n:
            block_size = struct.unpack_from("<i", data, off)[0]
            yield _parse_record(data, off + 4)
            off += 4 + block_size

    def fetch(self, chrom: str, start1: int, end1: int) -> Iterator[BamRecord]:
        """Records overlapping chrom:start1-end1 (1-based incl), file order."""
        rid = self._ref_ids.get(chrom)
        if rid is None:
            return
        beg0, end0 = int(start1) - 1, int(end1)
        if self._native is not None:
            text = self._native.bam_query(
                self._data, self._records_start, rid, beg0, end0)
            if text is not None:
                for line in text.splitlines():
                    name, flag, pos0, mapq, cigar, seq = line.split("\t")
                    yield BamRecord(name=name, flag=int(flag), ref_id=rid,
                                    pos0=int(pos0), mapq=int(mapq),
                                    cigar=cigar, seq=seq, qual=b"")
                return
        for rec in self:
            if rec.ref_id != rid:
                continue
            if rec.pos0 >= end0:
                continue
            if rec.end_pos0 > beg0 and rec.pos0 < end0:
                yield rec


def _parse_record(data: bytes, off: int) -> BamRecord:
    """The record whose fields start at ``data[off]`` (after its
    block_size): the fixed header and a view of the CIGAR words; name,
    bases and quality stay in ``data`` until read."""
    (ref_id, pos, l_read_name, mapq, _bin, n_cigar, flag,
     l_seq) = struct.unpack_from("<iiBBHHHi", data, off)
    rec = BamRecord.__new__(BamRecord)
    rec.flag, rec.ref_id, rec.pos0, rec.mapq, rec.l_seq = \
        flag, ref_id, pos, mapq, l_seq
    p = off + 32
    rec.words = np.frombuffer(data, "<u4", count=n_cigar,
                              offset=p + l_read_name)
    rec._buf, rec._p_name, rec._l_name = data, p, l_read_name
    rec._p_seq = p + l_read_name + 4 * n_cigar
    return rec


# ---------------------------------------------------------------------------
# BAM writing (test fixtures / simulation)
# ---------------------------------------------------------------------------

def _bgzf_compress_block(payload: bytes) -> bytes:
    comp = zlib.compressobj(6, zlib.DEFLATED, -15)
    cdata = comp.compress(payload) + comp.flush()
    bsize = len(cdata) + 25 + 1
    header = (b"\x1f\x8b\x08\x04" + b"\x00" * 6 +
              struct.pack("<H", 6) + b"BC" + struct.pack("<HH", 2, bsize - 1))
    footer = struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF,
                         len(payload))
    return header + cdata + footer


def _encode_seq(seq: str) -> bytes:
    out = bytearray()
    for i, base in enumerate(seq):
        nib = SEQ_NIBBLE.find(base.upper())
        if nib < 0:
            nib = 15  # N
        if i % 2 == 0:
            out.append(nib << 4)
        else:
            out[-1] |= nib
    return bytes(out)


def write_bam(path: str, references: List[Tuple[str, int]],
              records: List[BamRecord]) -> None:
    """Write a coordinate-order BAM (caller supplies sorted records)."""
    header_text = ("@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{name}\tLN:{length}\n" for name, length in references)
    ).encode("ascii")
    head = BAM_MAGIC + struct.pack("<i", len(header_text)) + header_text
    head += struct.pack("<i", len(references))
    for name, length in references:
        nm = name.encode("ascii") + b"\x00"
        head += struct.pack("<i", len(nm)) + nm + struct.pack("<i", length)

    # joined once at the end: appending to one bytes object copies it
    # whole each time, quadratic in the file's size
    body = []
    for rec in records:
        nm = rec.name.encode("ascii") + b"\x00"
        cig = rec.words.tobytes()
        seqb = _encode_seq(rec.seq)
        qual = rec.qual if rec.qual else b"\xff" * len(rec.seq)
        payload = struct.pack(
            "<iiBBHHHiiii", rec.ref_id, rec.pos0, len(nm), rec.mapq,
            0, len(cig) // 4, rec.flag, len(rec.seq), -1, -1, 0)
        payload += nm + cig + seqb + qual
        body.append(struct.pack("<i", len(payload)) + payload)

    with open(path, "wb") as out:
        blob = b"".join([head, *body])
        for i in range(0, max(len(blob), 1), 60000):
            chunk = blob[i:i + 60000]
            if chunk:
                out.write(_bgzf_compress_block(chunk))
        out.write(BGZF_EOF)
