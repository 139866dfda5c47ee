"""Writers of the generated inputs: FASTA with its FAI, BGZF BAM with its
BAI, VCF and BED.

They follow the SAM/BAM specification (BGZF blocks of at most 0xff00
payload bytes, the 5-level binning index with its 16 kb linear index
and the per-reference pseudo-bin, as htslib writes them), so the program
reads them as it would read a real call set's files.
"""
from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from .layout import ASCII, Event, Reads

BGZF_BLOCK = 0xff00
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
# 4-bit BAM base codes of A, C, G, T ("=ACMGRSVTWYHKDBN")
_NIBBLE = np.array([1, 2, 4, 8], np.uint8)
_LEVELS = [(26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)]
_PSEUDO_BIN = 37450


def write_fasta(path: str, contigs: Sequence[Tuple[str, np.ndarray]],
                width: int = 60) -> None:
    """FASTA of ACGT codes, `width` bases a line, and its .fai."""
    fai = []
    offset = 0
    with open(path, "wb") as fh:
        for name, codes in contigs:
            head = f">{name}\n".encode()
            fh.write(head)
            offset += len(head)
            n = len(codes)
            full = n // width
            body = np.full((full, width + 1), 10, np.uint8)
            body[:, :width] = ASCII[codes[:full * width]].reshape(full, width)
            fh.write(body.tobytes())
            tail = ASCII[codes[full * width:]].tobytes()
            if tail:
                fh.write(tail + b"\n")
            fai.append(f"{name}\t{n}\t{offset}\t{width}\t{width + 1}\n")
            offset += full * (width + 1) + (len(tail) + 1 if tail else 0)
    with open(path + ".fai", "w") as fh:
        fh.writelines(fai)


def reg2bin(beg: int, end: int) -> int:
    end -= 1
    for shift, off in reversed(_LEVELS):
        if beg >> shift == end >> shift:
            return off + (beg >> shift)
    return 0


def _record(ref_id: int, reads: Reads, i: int) -> bytes:
    name = reads.names[i].encode() + b"\0"
    cig = reads.cigar[i].astype("<u4").tobytes()
    codes = _NIBBLE[reads.seq[i]]
    l_seq = len(codes)
    if l_seq % 2:
        codes = np.append(codes, np.uint8(0))
    packed = ((codes[0::2] << 4) | codes[1::2]).tobytes()
    pos, end = int(reads.pos[i]), int(reads.end[i])
    body = struct.pack("<iiBBHHHiiii", ref_id, pos, len(name), 60,
                       reg2bin(pos, end), len(reads.cigar[i]),
                       int(reads.flag[i]), l_seq, -1, -1, 0)
    body += name + cig + packed + b"\xff" * l_seq
    return struct.pack("<i", len(body)) + body


def _compress(payload: bytes) -> bytes:
    comp = zlib.compressobj(6, zlib.DEFLATED, -15)
    data = comp.compress(payload) + comp.flush()
    size = len(data) + 26
    return (b"\x1f\x8b\x08\x04\0\0\0\0\0\xff" + struct.pack("<H", 6) +
            b"BC" + struct.pack("<HH", 2, size - 1) + data +
            struct.pack("<II", zlib.crc32(payload) & 0xffffffff,
                        len(payload)))


def write_bam(path: str, references: Sequence[Tuple[str, int]],
              per_ref: Iterable[Tuple[int, Reads]], threads: int = 4
              ) -> None:
    """Coordinate-sorted BAM of every (ref_id, reads) in order, and its
    .bai.  Reads are given in file order."""
    text = ("@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{n}\tLN:{ln}\n" for n, ln in references) +
        "@RG\tID:cell\tPL:PACBIO\tSM:sample\n"
        "@PG\tID:generator\tPN:benchmarks.gen\n").encode()
    head = [b"BAM\1", struct.pack("<i", len(text)), text,
            struct.pack("<i", len(references))]
    for n, ln in references:
        nm = n.encode() + b"\0"
        head += [struct.pack("<i", len(nm)), nm, struct.pack("<i", ln)]
    chunks = [b"".join(head)]
    offsets = []                      # (ref_id, start, end, pos, endpos)
    at = len(chunks[0])
    for ref_id, reads in per_ref:
        for i in range(len(reads.pos)):
            rec = _record(ref_id, reads, i)
            offsets.append((ref_id, at, at + len(rec), int(reads.pos[i]),
                            int(reads.end[i])))
            chunks.append(rec)
            at += len(rec)
    data = b"".join(chunks)
    del chunks
    blocks = [data[i:i + BGZF_BLOCK] for i in range(0, len(data), BGZF_BLOCK)]
    with ThreadPoolExecutor(threads) as pool:
        packed = list(pool.map(_compress, blocks))
    coff = np.zeros(len(packed) + 1, np.int64)
    coff[1:] = np.cumsum([len(b) for b in packed])
    with open(path, "wb") as fh:
        for b in packed:
            fh.write(b)
        fh.write(BGZF_EOF)
    _write_bai(path + ".bai", len(references), offsets, coff, len(data))


def _voffset(coff: np.ndarray, u: int) -> int:
    b, within = divmod(u, BGZF_BLOCK)
    return (int(coff[b]) << 16) | within


def _write_bai(path: str, n_ref: int, offsets, coff, total: int) -> None:
    bins: List[Dict[int, List[List[int]]]] = [{} for _ in range(n_ref)]
    linear: List[Dict[int, int]] = [{} for _ in range(n_ref)]
    span: List[List[int]] = [[0, 0, 0] for _ in range(n_ref)]
    for ref_id, start, stop, pos, endpos in offsets:
        vb = _voffset(coff, start)
        ve = _voffset(coff, stop)
        chunks = bins[ref_id].setdefault(reg2bin(pos, endpos), [])
        if chunks and chunks[-1][1] == vb:
            chunks[-1][1] = ve
        else:
            chunks.append([vb, ve])
        lin = linear[ref_id]
        for w in range(pos >> 14, ((endpos - 1) >> 14) + 1):
            lin.setdefault(w, vb)
        sp = span[ref_id]
        if sp[2] == 0:
            sp[0] = vb
        sp[1], sp[2] = ve, sp[2] + 1
    out = [b"BAI\1", struct.pack("<i", n_ref)]
    for r in range(n_ref):
        items = sorted(bins[r].items())
        out.append(struct.pack("<i", len(items) + (1 if span[r][2] else 0)))
        for b, chunks in items:
            out.append(struct.pack("<Ii", b, len(chunks)))
            for vb, ve in chunks:
                out.append(struct.pack("<QQ", vb, ve))
        if span[r][2]:
            out.append(struct.pack("<IiQQQQ", _PSEUDO_BIN, 2, span[r][0],
                                   span[r][1], span[r][2], 0))
        n_win = max(linear[r]) + 1 if linear[r] else 0
        lin = [0] * n_win
        for w, v in linear[r].items():
            lin[w] = v
        for w in range(1, n_win):
            if lin[w] == 0:
                lin[w] = lin[w - 1]
        out.append(struct.pack(f"<i{n_win}Q", n_win, *lin))
    with open(path, "wb") as fh:
        fh.write(b"".join(out))


def write_vcf(path: str, contigs: Sequence[Tuple[str, int]],
              events: Sequence[Event]) -> None:
    """VCF 4.2 of the call set: DEL with END, INS with SVLEN and SEQ."""
    lines = ["##fileformat=VCFv4.2"]
    lines += [f"##contig=<ID={n},length={ln}>" for n, ln in contigs]
    lines += [
        '##INFO=<ID=SVTYPE,Number=1,Type=String,Description="SV type">',
        '##INFO=<ID=END,Number=1,Type=Integer,Description="End">',
        '##INFO=<ID=SVLEN,Number=1,Type=Integer,Description="SV length">',
        '##INFO=<ID=SEQ,Number=1,Type=String,Description="Insert">',
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tHG002"]
    for ev in events:
        gt = "1/1" if ev.hom else "0/1"
        if ev.kind == "INS":
            info = (f"SVTYPE=INS;END={ev.s};SVLEN={ev.size};"
                    f"SEQ={ev.ins.decode()}")
        else:
            info = f"SVTYPE={ev.kind};END={ev.e};SVLEN=-{ev.size}"
        lines.append(f"{ev.contig}\t{ev.s}\t{ev.svid}\tN\t<{ev.kind}>\t.\t"
                     f"PASS\t{info}\tGT\t{gt}")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def write_bed(path: str, events: Sequence[Event]) -> None:
    """5-column BED of the call set (chrom, start, end, id, type), as the
    upstream's ``vapor bed`` reads it."""
    with open(path, "w") as fh:
        for ev in events:
            fh.write(f"{ev.contig}\t{ev.s}\t{ev.e}\t{ev.svid}\t{ev.kind}\n")
