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
-access path (io/bai.py, ``IndexedBam``) when an index is present; the
pure-Python whole-file scan below serves index-less files.
"""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

BAM_MAGIC = b"BAM\x01"
CIGAR_OPS = "MIDNSHP=X"
SEQ_NIBBLE = "=ACMGRSVTWYHKDBN"
_REF_CONSUMING = {"M", "D", "N", "=", "X"}

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


@dataclass
class BamRecord:
    name: str
    flag: int
    ref_id: int
    pos0: int              # 0-based leftmost coordinate
    mapq: int
    cigar: str             # expanded text form, e.g. "10S90M2D100M"
    seq: str
    qual: bytes

    @property
    def ref_length(self) -> int:
        """Reference bases consumed by the alignment (for endpos)."""
        total = 0
        num = 0
        for ch in self.cigar:
            if ch.isdigit():
                num = num * 10 + ord(ch) - 48
            else:
                if ch in _REF_CONSUMING:
                    total += num
                num = 0
        return total

    @property
    def end_pos0(self) -> int:
        return self.pos0 + self.ref_length


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
    """Whole-file BAM decoder with region iteration (pure-Python BGZF)."""

    def __init__(self, path: str):
        self.path = path
        data = _decompress_bgzf(path)
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
        for rec in self:
            if rec.ref_id != rid:
                continue
            if rec.pos0 >= end0:
                continue
            if rec.end_pos0 > beg0 and rec.pos0 < end0:
                yield rec


_SEQ_NIB_LUT = None        # lazy: numpy byte LUT for 4-bit seq codes


def _parse_record(data: bytes, off: int) -> BamRecord:
    (ref_id, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq,
     _nrid, _npos, _tlen) = struct.unpack_from("<iiBBHHHiiii", data, off)
    p = off + 32
    name = data[p: p + l_read_name - 1].decode("ascii")
    p += l_read_name
    cigar_parts = []
    for i in range(n_cigar):
        v = struct.unpack_from("<I", data, p + 4 * i)[0]
        cigar_parts.append(f"{v >> 4}{CIGAR_OPS[v & 0xF]}")
    cigar = "".join(cigar_parts) if cigar_parts else "*"
    p += 4 * n_cigar
    nbytes = (l_seq + 1) // 2
    # vectorized nibble decode: the per-base Python loop was the
    # dominant host cost of BAI-chunk reads (~37 ms/event at 2.5 kb
    # reads)
    global _SEQ_NIB_LUT
    import numpy as np
    if _SEQ_NIB_LUT is None:
        _SEQ_NIB_LUT = np.frombuffer(SEQ_NIBBLE.encode("ascii"),
                                     dtype=np.uint8)
    packed = np.frombuffer(data, np.uint8, count=nbytes, offset=p)
    codes = np.empty(nbytes * 2, np.uint8)
    codes[0::2] = packed >> 4
    codes[1::2] = packed & 0xF
    seq = _SEQ_NIB_LUT[codes[:l_seq]].tobytes().decode("ascii")
    p += nbytes
    qual = data[p: p + l_seq]
    return BamRecord(name=name, flag=flag, ref_id=ref_id, pos0=pos,
                     mapq=mapq, cigar=cigar, seq=seq, qual=qual)


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


def _encode_cigar(cigar: str) -> bytes:
    out = b""
    num = 0
    for ch in cigar:
        if ch.isdigit():
            num = num * 10 + ord(ch) - 48
        else:
            out += struct.pack("<I", (num << 4) | CIGAR_OPS.index(ch))
            num = 0
    return out


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

    body = b""
    for rec in records:
        nm = rec.name.encode("ascii") + b"\x00"
        cig = _encode_cigar(rec.cigar) if rec.cigar != "*" else b""
        seqb = _encode_seq(rec.seq)
        qual = rec.qual if rec.qual else b"\xff" * len(rec.seq)
        payload = struct.pack(
            "<iiBBHHHiiii", rec.ref_id, rec.pos0, len(nm), rec.mapq,
            0, len(cig) // 4, rec.flag, len(rec.seq), -1, -1, 0)
        payload += nm + cig + seqb + qual
        body += struct.pack("<i", len(payload)) + payload

    with open(path, "wb") as out:
        blob = head + body
        for i in range(0, max(len(blob), 1), 60000):
            chunk = blob[i:i + 60000]
            if chunk:
                out.write(_bgzf_compress_block(chunk))
        out.write(BGZF_EOF)
