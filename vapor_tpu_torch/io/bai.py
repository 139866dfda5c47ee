"""BAI index support: random access into coordinate-sorted BAMs.

The reference relies on `samtools view` region queries, which need a
`.bai`; whole-genome BAMs are tens of GB, so decompressing the full
BGZF stream per process (the BamReader baseline) is a test-only
strategy.  This module implements the standard 5-level binning index:

* `read_bai`   — parse a `.bai` into per-reference bin->chunks maps
  plus the 16 kb linear index;
* `write_bai`  — build an index for BAMs produced by `write_bam`
  (fixture/simulation support and round-trip testing);
* `IndexedBam` — region fetch that inflates only the BGZF blocks the
  index points at, yielding records in file order with htslib overlap
  semantics — byte-equal behavior to the full-scan reader.

Virtual offsets are `coffset << 16 | uoffset` as in the SAM spec.
"""
from __future__ import annotations

import struct
import threading
import zlib
from typing import Dict, Iterator, List, Tuple

from ..utils import trace
from .bam import BAM_MAGIC, BamRecord, _parse_record

BAI_MAGIC = b"BAI\x01"
_LEVELS = [(26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)]


def reg2bin(beg: int, end: int) -> int:
    """Deepest bin containing [beg, end) (SAM spec §5.3)."""
    end -= 1
    for shift, offset in reversed(_LEVELS):
        if beg >> shift == end >> shift:
            return offset + (beg >> shift)
    return 0


def reg2bins(beg: int, end: int) -> List[int]:
    """All bins overlapping [beg, end)."""
    bins = [0]
    end -= 1
    for shift, offset in _LEVELS:
        bins.extend(range(offset + (beg >> shift),
                          offset + (end >> shift) + 1))
    return bins


def read_bai(path: str) -> List[Tuple[Dict[int, List[Tuple[int, int]]],
                                      List[int]]]:
    """[(bins, linear_index), ...] per reference."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:4] != BAI_MAGIC:
        raise ValueError(f"{path}: not a BAI index")
    off = 4
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    out = []
    for _ in range(n_ref):
        (n_bin,) = struct.unpack_from("<i", data, off)
        off += 4
        bins: Dict[int, List[Tuple[int, int]]] = {}
        for _ in range(n_bin):
            bin_id, n_chunk = struct.unpack_from("<Ii", data, off)
            off += 8
            chunks = []
            for _ in range(n_chunk):
                beg, end = struct.unpack_from("<QQ", data, off)
                off += 16
                chunks.append((beg, end))
            bins[bin_id] = chunks
        (n_intv,) = struct.unpack_from("<i", data, off)
        off += 4
        linear = list(struct.unpack_from(f"<{n_intv}Q", data, off))
        off += 8 * n_intv
        out.append((bins, linear))
    return out


def write_bai(bam_path: str, out_path: str = "") -> str:
    """Build a `.bai` for a coordinate-sorted BAM (any BGZF layout)."""
    out_path = out_path or bam_path + ".bai"
    # walk BGZF blocks recording (file_offset, payload) boundaries
    with open(bam_path, "rb") as fh:
        raw = fh.read()
    blocks: List[Tuple[int, bytes]] = []
    pos = 0
    while pos < len(raw):
        xlen = struct.unpack_from("<H", raw, pos + 10)[0]
        extra = raw[pos + 12: pos + 12 + xlen]
        bsize = None
        e = 0
        while e + 4 <= len(extra):
            si1, si2 = extra[e], extra[e + 1]
            slen = struct.unpack_from("<H", extra, e + 2)[0]
            if si1 == 0x42 and si2 == 0x43 and slen == 2:
                bsize = struct.unpack_from("<H", extra, e + 4)[0] + 1
            e += 4 + slen
        payload = zlib.decompress(raw[pos + 12 + xlen: pos + bsize - 8],
                                  wbits=-15)
        if payload:
            blocks.append((pos, payload))
        pos += bsize

    # uncompressed offset -> virtual offset
    bounds = []
    total = 0
    for coff, payload in blocks:
        bounds.append((total, coff, len(payload)))
        total += len(payload)
    data = b"".join(p for _, p in blocks)

    def voffset(uncomp_off: int) -> int:
        lo, hi = 0, len(bounds) - 1
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if bounds[mid][0] <= uncomp_off:
                lo = mid
            else:
                hi = mid - 1
        start, coff, _ = bounds[lo]
        return (coff << 16) | (uncomp_off - start)

    if data[:4] != BAM_MAGIC:
        raise ValueError("not a BAM stream")
    l_text = struct.unpack_from("<i", data, 4)[0]
    off = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    for _ in range(n_ref):
        l_name = struct.unpack_from("<i", data, off)[0]
        off += 8 + l_name

    per_ref: List[Dict[int, List[Tuple[int, int]]]] = [
        {} for _ in range(n_ref)]
    linear: List[List[int]] = [[] for _ in range(n_ref)]
    n = len(data)
    while off + 4 <= n:
        block_size = struct.unpack_from("<i", data, off)[0]
        v_beg = voffset(off)
        v_end = voffset(off + 4 + block_size) \
            if off + 4 + block_size < n else \
            ((bounds[-1][1] << 16) | bounds[-1][2])
        rec = _parse_record(data, off + 4)
        off += 4 + block_size
        if rec.ref_id < 0:
            continue
        beg0 = rec.pos0
        end0 = max(rec.end_pos0, beg0 + 1)
        b = reg2bin(beg0, end0)
        per_ref[rec.ref_id].setdefault(b, []).append((v_beg, v_end))
        win_lo, win_hi = beg0 >> 14, (end0 - 1) >> 14
        lin = linear[rec.ref_id]
        while len(lin) <= win_hi:
            lin.append(0)
        for w in range(win_lo, win_hi + 1):
            if lin[w] == 0 or v_beg < lin[w]:
                lin[w] = v_beg

    out = [BAI_MAGIC, struct.pack("<i", n_ref)]
    for rid in range(n_ref):
        bins = per_ref[rid]
        # merge adjacent chunks per bin
        merged: Dict[int, List[Tuple[int, int]]] = {}
        for b, chunks in bins.items():
            chunks.sort()
            acc = [list(chunks[0])]
            for beg, end in chunks[1:]:
                if beg <= acc[-1][1]:
                    acc[-1][1] = max(acc[-1][1], end)
                else:
                    acc.append([beg, end])
            merged[b] = [(a, b2) for a, b2 in acc]
        out.append(struct.pack("<i", len(merged)))
        for b in sorted(merged):
            out.append(struct.pack("<Ii", b, len(merged[b])))
            for beg, end in merged[b]:
                out.append(struct.pack("<QQ", beg, end))
        out.append(struct.pack("<i", len(linear[rid])))
        out.append(struct.pack(f"<{len(linear[rid])}Q", *linear[rid]))
    with open(out_path, "wb") as fh:
        fh.write(b"".join(out))
    return out_path


class IndexedBam:
    """Region fetch through a `.bai` — inflates only needed blocks."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "rb")
        self._lock = threading.Lock()
        self._index = read_bai(path + ".bai")
        self._block_cache: Dict[int, Tuple[bytes, int]] = {}
        # parse header by streaming blocks from offset 0
        head = b""
        coff = 0
        def need(n):
            nonlocal head, coff
            while len(head) < n:
                payload, bsize = self._inflate_at(coff)
                if not payload and not bsize:
                    raise ValueError("truncated BAM header")
                head += payload
                coff += bsize
        need(12)
        if head[:4] != BAM_MAGIC:
            raise ValueError(f"{path}: not a BAM file")
        l_text = struct.unpack_from("<i", head, 4)[0]
        need(8 + l_text + 4)
        off = 8 + l_text
        (n_ref,) = struct.unpack_from("<i", head, off)
        off += 4
        self.references: List[str] = []
        for _ in range(n_ref):
            need(off + 4)
            l_name = struct.unpack_from("<i", head, off)[0]
            need(off + 8 + l_name)
            self.references.append(
                head[off + 4: off + 4 + l_name - 1].decode("ascii"))
            off += 8 + l_name
        self._ref_ids = {nm: i for i, nm in enumerate(self.references)}

    # -- BGZF block access ------------------------------------------------

    def _inflate_at(self, coffset: int) -> Tuple[bytes, int]:
        """(payload, compressed_size) of the block at file offset."""
        if coffset in self._block_cache:
            return self._block_cache[coffset]
        with trace.span("bam.inflate"):
            return self._inflate_miss(coffset)

    def _inflate_miss(self, coffset: int) -> Tuple[bytes, int]:
        with self._lock:
            self._fh.seek(coffset)
            head = self._fh.read(12)
            if len(head) < 12:
                return b"", 0
            xlen = struct.unpack_from("<H", head, 10)[0]
            extra = self._fh.read(xlen)
            if len(extra) < xlen:
                return b"", 0
            bsize = None
            e = 0
            while e + 4 <= xlen:
                si1, si2 = extra[e], extra[e + 1]
                slen = struct.unpack_from("<H", extra, e + 2)[0]
                if si1 == 0x42 and si2 == 0x43 and slen == 2:
                    bsize = struct.unpack_from("<H", extra, e + 4)[0] + 1
                e += 4 + slen
            if bsize is None:
                return b"", 0
            cdata = self._fh.read(bsize - 12 - xlen - 8)
        payload = zlib.decompress(cdata, wbits=-15)
        trace.count("bam.blocks_inflated")
        self._block_cache[coffset] = (payload, bsize)
        if len(self._block_cache) > 512:
            self._block_cache.pop(next(iter(self._block_cache)))
        return payload, bsize

    # -- region query -----------------------------------------------------

    def fetch(self, chrom: str, start1: int,
              end1: int) -> Iterator[BamRecord]:
        rid = self._ref_ids.get(chrom)
        if rid is None or rid >= len(self._index):
            return
        beg0, end0 = max(0, int(start1) - 1), int(end1)
        bins, linear = self._index[rid]
        chunks: List[Tuple[int, int]] = []
        for b in reg2bins(beg0, end0):
            chunks.extend(bins.get(b, []))
        if not chunks:
            return
        win = beg0 >> 14
        min_off = linear[win] if win < len(linear) else \
            (linear[-1] if linear else 0)
        chunks = sorted(c for c in chunks if c[1] > min_off)
        if not chunks:
            return
        merged = [list(chunks[0])]
        for beg, end in chunks[1:]:
            if beg <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([beg, end])
        for v_beg, v_end in merged:
            yield from self._scan_chunk(v_beg, v_end, rid, beg0, end0)

    def _scan_chunk(self, v_beg: int, v_end: int, rid: int,
                    beg0: int, end0: int) -> Iterator[BamRecord]:
        coffset, uoffset = v_beg >> 16, v_beg & 0xFFFF
        buf = b""
        # blocks_meta: (start offset of block payload in buf, coffset)
        blocks_meta: List[Tuple[int, int]] = []
        next_coff = coffset
        pos = uoffset

        def extend() -> bool:
            nonlocal buf, next_coff
            payload, bsize = self._inflate_at(next_coff)
            if not payload and not bsize:
                return False
            blocks_meta.append((len(buf), next_coff))
            buf += payload
            next_coff += bsize
            return bsize > 0

        if not extend():
            return
        while True:
            while len(buf) < pos + 4:
                if not extend():
                    return
            # virtual offset of this record start (chunk-end bound)
            bstart, bcoff = next(
                (bs, bc) for bs, bc in reversed(blocks_meta)
                if bs <= pos)
            voff = (bcoff << 16) | (pos - bstart)
            if voff >= v_end:
                return
            block_size = struct.unpack_from("<i", buf, pos)[0]
            while len(buf) < pos + 4 + block_size:
                if not extend():
                    return
            with trace.span("bam.parse"):
                rec = _parse_record(buf, pos + 4)
            trace.count("bam.records_parsed")
            pos += 4 + block_size
            if rec.ref_id != rid or rec.pos0 >= end0:
                return
            # closed before the yield: the caller clips between yields
            with trace.span("bam.overlap"):
                hit = rec.end_pos0 > beg0 and rec.pos0 < end0
            if hit:
                yield rec
