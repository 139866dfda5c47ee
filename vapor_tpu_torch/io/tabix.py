"""Tabix-compatible .tbi index over BGZF-compressed tab-text output.

The reference pipeline tabixes its merged `.vapor.bed.gz` so downstream
tools can region-query it (the reference's wdl/TasksBenchmark.wdl:303-309,
`tabix -p bed`).  This module writes the same on-disk formats with the
framework's own codecs (no htslib): `write_bgzf_indexed` emits the BGZF
file plus `<path>.tbi`, and `tabix_query` resolves a region through the
index (bins + linear index + virtual file offsets) back to rows.

Formats per the htslib tabix spec: the index payload is itself BGZF;
virtual offsets are (compressed_block_offset << 16) | in_block_offset;
bins/linear index use the UCSC scheme shared with BAI (io/bai.py
reg2bin/reg2bins).
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Tuple

from .bai import reg2bin, reg2bins
from .bam import BGZF_EOF, _bgzf_compress_block

BLOCK = 60000
FMT_ZERO_BASED = 0x10000      # generic, 0-based half-open (BED-like)


def _bgzf_write_blocks(data: bytes) -> Tuple[bytes, List[Tuple[int, int]]]:
    """Compress `data` into BGZF blocks; returns (file bytes, block map
    [(uncompressed_start, compressed_offset)])."""
    out = bytearray()
    blocks: List[Tuple[int, int]] = []
    for i in range(0, max(len(data), 1), BLOCK):
        chunk = data[i:i + BLOCK]
        if chunk or i == 0:
            blocks.append((i, len(out)))
            out += _bgzf_compress_block(chunk)
    out += BGZF_EOF
    return bytes(out), blocks


def _voffset(blocks: List[Tuple[int, int]], text_off: int) -> int:
    """Virtual file offset of an uncompressed byte position."""
    lo, hi = 0, len(blocks) - 1
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if blocks[mid][0] <= text_off:
            lo = mid
        else:
            hi = mid - 1
    ustart, coff = blocks[lo]
    return (coff << 16) | (text_off - ustart)


def write_bgzf_indexed(path: str, text: str, col_seq: int = 1,
                       col_beg: int = 2, col_end: int = 3,
                       meta: str = "#") -> None:
    """Write `text` BGZF-compressed to `path` and a tabix index to
    `path`.tbi (0-based half-open coordinates, BED-like)."""
    data = text.encode()
    file_bytes, blocks = _bgzf_write_blocks(data)
    with open(path, "wb") as fo:
        fo.write(file_bytes)

    names: List[str] = []
    # per ref: {bin: [(vbeg, vend)]} and 16kb linear index {intv: voff}
    bins: List[Dict[int, List[Tuple[int, int]]]] = []
    linear: List[Dict[int, int]] = []
    off = 0
    for line in data.decode().splitlines(keepends=True):
        start_off = off
        off += len(line.encode())
        if not line.strip() or line.startswith(meta):
            continue
        cols = line.split("\t")
        chrom = cols[col_seq - 1]
        beg0 = int(cols[col_beg - 1])
        end0 = int(cols[col_end - 1]) if col_end else beg0 + 1
        end0 = max(end0, beg0 + 1)
        if chrom not in names:
            names.append(chrom)
            bins.append({})
            linear.append({})
        rid = names.index(chrom)
        vbeg = _voffset(blocks, start_off)
        vend = _voffset(blocks, off)
        bins[rid].setdefault(reg2bin(beg0, end0), []).append((vbeg, vend))
        for w in range(beg0 >> 14, ((end0 - 1) >> 14) + 1):
            if w not in linear[rid] or vbeg < linear[rid][w]:
                linear[rid][w] = vbeg

    payload = bytearray()
    payload += b"TBI\x01"
    name_blob = b"".join(n.encode() + b"\x00" for n in names)
    payload += struct.pack("<8i", len(names), FMT_ZERO_BASED, col_seq,
                           col_beg, col_end, ord(meta), 0,
                           len(name_blob))
    payload += name_blob
    for rid in range(len(names)):
        payload += struct.pack("<i", len(bins[rid]))
        for b in sorted(bins[rid]):
            chunks = bins[rid][b]
            payload += struct.pack("<Ii", b, len(chunks))
            for vbeg, vend in chunks:
                payload += struct.pack("<QQ", vbeg, vend)
        n_intv = (max(linear[rid]) + 1) if linear[rid] else 0
        payload += struct.pack("<i", n_intv)
        last = 0
        for w in range(n_intv):
            last = linear[rid].get(w, last) or last
            # empty leading windows point at the first record's offset
            v = linear[rid].get(w, last)
            payload += struct.pack("<Q", v)
    idx_bytes, _ = _bgzf_write_blocks(bytes(payload))
    with open(path + ".tbi", "wb") as fo:
        fo.write(idx_bytes)


def _bgzf_blocks_with_offsets(raw: bytes
                              ) -> List[Tuple[int, int, bytes]]:
    """[(compressed_offset, uncompressed_start, payload)] for a BGZF
    file's blocks."""
    out = []
    pos = 0
    usum = 0
    while pos + 18 <= len(raw):
        if raw[pos:pos + 2] != b"\x1f\x8b":
            raise ValueError("not BGZF")
        xlen = struct.unpack_from("<H", raw, pos + 10)[0]
        extra = raw[pos + 12: pos + 12 + xlen]
        bsize = None
        e = 0
        while e + 4 <= len(extra):
            si1, si2, slen = extra[e], extra[e + 1], \
                struct.unpack_from("<H", extra, e + 2)[0]
            if si1 == 66 and si2 == 67:
                bsize = struct.unpack_from("<H", extra, e + 4)[0] + 1
            e += 4 + slen
        if bsize is None:
            raise ValueError("missing BGZF BC field")
        payload = zlib.decompress(
            raw[pos + 12 + xlen: pos + bsize - 8], -15)
        if payload:
            out.append((pos, usum, payload))
        usum += len(payload)
        pos += bsize
    return out


def _read_index(path: str):
    raw = open(path, "rb").read()
    data = b"".join(p for _, _, p in _bgzf_blocks_with_offsets(raw))
    if data[:4] != b"TBI\x01":
        raise ValueError("not a .tbi index")
    (n_ref, fmt, col_seq, col_beg, col_end, meta, skip,
     l_nm) = struct.unpack_from("<8i", data, 4)
    off = 36
    names = data[off:off + l_nm].split(b"\x00")[:-1]
    names = [n.decode() for n in names]
    off += l_nm
    refs = []
    for _ in range(n_ref):
        n_bin = struct.unpack_from("<i", data, off)[0]
        off += 4
        b: Dict[int, List[Tuple[int, int]]] = {}
        for _ in range(n_bin):
            bno, n_chunk = struct.unpack_from("<Ii", data, off)
            off += 8
            chunks = []
            for _ in range(n_chunk):
                vb, ve = struct.unpack_from("<QQ", data, off)
                off += 16
                chunks.append((vb, ve))
            b[bno] = chunks
        n_intv = struct.unpack_from("<i", data, off)[0]
        off += 4
        ioff = list(struct.unpack_from(f"<{n_intv}Q", data, off))
        off += 8 * n_intv
        refs.append((b, ioff))
    return names, refs, (fmt, col_seq, col_beg, col_end, meta)


def tabix_query(path: str, chrom: str, beg0: int, end0: int
                ) -> List[List[str]]:
    """Rows of the BGZF file at `path` overlapping [beg0, end0), found
    through `path`.tbi (bins -> chunks -> virtual offsets)."""
    names, refs, conf = _read_index(path + ".tbi")
    if chrom not in names:
        return []
    rid = names.index(chrom)
    bin_map, ioff = refs[rid]
    min_voff = ioff[beg0 >> 14] if (beg0 >> 14) < len(ioff) else 0
    chunks = []
    for b in reg2bins(beg0, end0):
        for vb, ve in bin_map.get(b, []):
            if ve > min_voff:
                chunks.append((max(vb, min_voff), ve))
    if not chunks:
        return []
    blocks = _bgzf_blocks_with_offsets(open(path, "rb").read())
    cmap = {coff: ustart for coff, ustart, _ in blocks}
    text = b"".join(p for _, _, p in blocks)

    def resolve(v: int) -> int:
        return cmap[v >> 16] + (v & 0xFFFF)

    _, col_seq, col_beg, col_end, _ = conf
    out = []
    seen = set()
    for vb, ve in sorted(chunks):
        lo, hi = resolve(vb), resolve(ve)
        if (lo, hi) in seen:
            continue
        seen.add((lo, hi))
        for line in text[lo:hi].decode().splitlines():
            if not line.strip():
                continue
            cols = line.split("\t")
            if cols[col_seq - 1] != chrom:
                continue
            b0 = int(cols[col_beg - 1])
            e0 = max(int(cols[col_end - 1]), b0 + 1)
            if b0 < end0 and e0 > beg0 and cols not in out:
                out.append(cols)
    return out
