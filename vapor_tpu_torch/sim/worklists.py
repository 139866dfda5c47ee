"""The port's own synthetic worklists, made with numpy: SV calls and
noisy long reads on one contig or a few.  They have no counterpart in
the JAX package (``sim/scale.py`` is the counterpart of its
``sim/scale.py``).

``build_event_worklist`` writes a bed worklist of DEL, INV and tandem-DUP
calls, on one contig or dealt round robin over several (the scale-out
paths' worklist); ``build_vcf_worklist`` a VCF of the
duplication-bearing events that the vcf subcommand scores with the
redefine-diagonal scorer (DISDUP, DUP_INV and a complex ``Other=``
event with a duplicated block).  ``repeat_rows`` makes engine rows (no
files) whose haplotypes and reads are a third tandem repeat, where
dot-plot hits are dense.
Made from a seed with numpy and written with the package's own
FASTA, BAM and BAI writers, so a run needs no external genome.  Every
event gets READS_EACH spanning reads, half from the donor haplotype
(carrying the SV) and half from the reference (a het call), with
PacBio-like noise: substitutions, insertions and deletions in equal parts
at rate ERR.  Reference reads carry CIGARs that follow their indels;
donor reads carry an all-M CIGAR, which the read clipper only uses to
find the window entry point.
"""
from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from ..engine.constants import HAP_PAD, READ_PAD
from ..io.bai import write_bai
from ..io.bam import BamRecord, write_bam
from ..io.fasta import write_fasta

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_OPS = "MID"

READS_EACH = 20      # spanning reads per event (ideal_read_list_length)
ERR = 0.08           # PacBio-like error rate
FLANK = 500          # reads enter the window left of start - FLANK ...
LEAD = 1500          # ... by up to LEAD bp
GAP = 2 * LEAD + 2 * FLANK + 2000   # between events
# bed: DEL and INV at each body REPS times, one DEL and one INV of BIG bp
# (junction mode), then tandem DUPs at each of DUP_BODIES REPS times
BODIES = (400, 900, 1400, 3000, 6000, 9500)
REPS = 2
BIG = 25000
DUP_BODIES = (400, 1400, 3000, 6000)
# vcf: (kind, block length, distance from the block's end to the insert
# point or, for Other, the second block's length) at a small and a large
# size, each VCF_REPS times, smallest first
VCF_SIZES = ((("DISDUP", 300, 600), ("DUP_INV", 300, 600),
              ("Other", 300, 400)),
             (("DISDUP", 1500, 2500), ("DUP_INV", 1200, 2000),
              ("Other", 1000, 1500)))
VCF_REPS = 4
VCF_EVENTS = tuple(ev for size in VCF_SIZES for _ in range(VCF_REPS)
                   for ev in size)
REPEAT_UNIT = 6      # repeat_rows: tandem-repeat unit, bp


def _revcomp(codes: np.ndarray) -> np.ndarray:
    return (3 - codes)[::-1]          # codes 0..3 = A C G T


def _cigar(ops: np.ndarray) -> str:
    cut = np.flatnonzero(np.diff(ops)) + 1
    starts = np.concatenate([[0], cut])
    lens = np.diff(np.concatenate([starts, [ops.size]]))
    return "".join(f"{n}{_OPS[ops[s]]}" for s, n in zip(starts, lens))


def noisy_read(template: np.ndarray, rng: np.random.Generator,
               err: float) -> Tuple[np.ndarray, str]:
    """(read codes, CIGAR against the template) for one read."""
    u = rng.random(template.size)
    sub = u < err / 3
    ins = (u >= err / 3) & (u < 2 * err / 3)
    dele = (u >= 2 * err / 3) & (u < err)
    base = template.copy()
    base[sub] = (base[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    # each template base yields 0 (deleted), 1, or 2 (inserted + base)
    counts = np.where(dele, 0, np.where(ins, 2, 1))
    ends = np.cumsum(counts)
    out = np.empty(int(ends[-1]), dtype=np.uint8)
    out[ends[~dele] - 1] = base[~dele]
    out[ends[ins] - 2] = rng.integers(0, 4, int(ins.sum()))
    op_ends = np.cumsum(np.where(ins, 2, 1))
    ops = np.zeros(int(op_ends[-1]), dtype=np.int8)
    ops[op_ends[ins] - 2] = 1
    ops[op_ends[dele] - 1] = 2
    return out, _cigar(ops)


def event_layout() -> List[Tuple[str, int]]:
    """(svtype, body) of every bed event, in order."""
    out = [(t, body) for body in BODIES for _ in range(REPS)
           for t in ("DEL", "INV")]
    return out + [("DEL", BIG), ("INV", BIG)] + \
        [("DUP", body) for body in DUP_BODIES for _ in range(REPS)]


def _donor(ref: np.ndarray, svtype: str, s0: int, e0: int) -> np.ndarray:
    if svtype == "DEL":
        return np.concatenate([ref[:s0], ref[e0:]])
    if svtype == "INV":
        return np.concatenate([ref[:s0], _revcomp(ref[s0:e0]), ref[e0:]])
    return np.concatenate([ref[:e0], ref[s0:e0], ref[e0:]])      # DUP


def _span_reads(ref, donor, anchor: int, read_len: int,
                rng: np.random.Generator
                ) -> List[Tuple[int, np.ndarray, str]]:
    """(pos0, codes, CIGAR) of READS_EACH reads entering the window left
    of anchor - FLANK, alternately from the donor and the reference."""
    out = []
    for r in range(READS_EACH):
        start = int(rng.integers(anchor - FLANK - LEAD, anchor - FLANK - 100))
        from_donor = r % 2 == 0
        template = (donor if from_donor else ref)[start:start + read_len]
        seq, cigar = noisy_read(template, rng, ERR)
        out.append((start, seq, f"{seq.size}M" if from_donor else cigar))
    return out


def contig_name(c: int) -> str:
    """Name of the c-th synthetic contig: chrE, chrF, ... (in version
    order, the order of the merged scale-out outputs)."""
    return "chr" + chr(ord("E") + c)


def _write(tmpdir: str, refs: List[np.ndarray], reads) -> Tuple[str, str]:
    """Writes ref.fa (+ .fai) with contig c holding refs[c], and a
    sorted, indexed reads.bam of reads (contig index, pos0, codes,
    CIGAR)."""
    reads = sorted(reads, key=lambda x: x[:2])
    records = [BamRecord(name=f"r{i}", flag=0, ref_id=c, pos0=p, mapq=60,
                         cigar=cigar, seq=BASES[seq].tobytes().decode(),
                         qual=b"")
               for i, (c, p, seq, cigar) in enumerate(reads)]
    fa = os.path.join(tmpdir, "ref.fa")
    bam = os.path.join(tmpdir, "reads.bam")
    write_fasta(fa, {contig_name(c): BASES[ref].tobytes().decode()
                     for c, ref in enumerate(refs)})
    write_bam(bam, [(contig_name(c), ref.size) for c, ref in enumerate(refs)],
              records)
    write_bai(bam)
    return fa, bam


def build_event_worklist(tmpdir: str, seed: int, n_contigs: int = 1):
    """Writes ref.fa (+ .fai), reads.bam (+ .bai) and svs.bed under
    tmpdir: the event_layout() events, event i on contig i % n_contigs
    (contig_name), the bed sorted by contig and position.  Returns
    (fasta, bam, bed, events) with events a list of (svtype, start0,
    end0) in the bed's row order.  A tandem DUP's alt haplotype is
    2 x body + 2 x flank, and its reads run through s + 2 (e - s) +
    flank: at the largest of DUP_BODIES (6000) both fit the largest
    bucket, 16384."""
    rng = np.random.default_rng(seed)
    layout = event_layout()
    home = [i % n_contigs for i in range(len(layout))]
    # a DUP's reads reach one body further right: so does its gap
    genome_lens = [GAP] * n_contigs
    for (t, body), c in zip(layout, home):
        genome_lens[c] += body * (2 if t == "DUP" else 1) + GAP
    refs = [rng.integers(0, 4, n).astype(np.uint8) for n in genome_lens]
    reads, rows, pos = [], [], [GAP] * n_contigs
    for i, ((svtype, body), c) in enumerate(zip(layout, home)):
        s0, e0 = pos[c], pos[c] + body
        pos[c] = e0 + GAP + (body if svtype == "DUP" else 0)
        # whole-event mode needs reads through the event's right flank
        # (e0 + flank, for a DUP s0 + 2 body + flank); junction mode only
        # around s0
        span = (2 * body if svtype == "DUP" else body) if body < 10000 \
            else 0
        reads += [(c, *r) for r in _span_reads(
            refs[c], _donor(refs[c], svtype, s0, e0), s0,
            span + 2 * FLANK + LEAD + 1000, rng)]
        rows.append((c, s0, e0, i, svtype))
    fa, bam = _write(tmpdir, refs, reads)
    rows.sort()
    bed = os.path.join(tmpdir, "svs.bed")
    with open(bed, "w") as fh:
        fh.write("".join(f"{contig_name(c)}\t{s}\t{e}\tSV{i}\t{t}\n"
                         for c, s, e, i, t in rows))
    return fa, bam, bed, [(t, s, e) for _, s, e, _, t in rows]


def repeat_rows(H: int, R: int, B: int, seed: int, ms=(0,)):
    """(haps, reads, rlens, ms) numpy engine rows, dense in hits.

    Each hap is a random flank, a tandem repeat of one REPEAT_UNIT bp
    unit and a random flank, a third each.  Each read is a noisy_read
    copy (rate ERR) of the hap's left flank end, the same repeat and the
    right flank start, again a third each: the two share flanks (a
    diagonal of hits) and repeat (hits on every sixth diagonal of the
    repeat x repeat block).  Every other read is reverse-complemented, so
    the reverse strand hits too.  Bytes as the engine takes them: ASCII
    bases with HAP_PAD / READ_PAD tails; row b gets m = ms[b % len(ms)]."""
    rng = np.random.default_rng(seed)
    haps = np.full((B, H), HAP_PAD, np.uint8)
    reads = np.full((B, R), READ_PAD, np.uint8)
    rlens = np.zeros(B, np.int32)
    for b in range(B):
        n = H - int(rng.integers(5, 60))
        unit = rng.integers(0, 4, REPEAT_UNIT).astype(np.uint8)
        left = rng.integers(0, 4, n // 3).astype(np.uint8)
        right = rng.integers(0, 4, n - 2 * (n // 3)).astype(np.uint8)
        haps[b, :n] = BASES[np.concatenate(
            [left, np.resize(unit, n // 3), right])]
        third = (R - int(rng.integers(60, 120))) // 3
        template = np.concatenate([left[max(0, left.size - third):],
                                   np.resize(unit, third),
                                   right[:third]])
        read = noisy_read(template, rng, ERR)[0][:R - 1]
        if b % 2:
            read = _revcomp(read)
        reads[b, :read.size] = BASES[read]
        rlens[b] = read.size
    m = np.array([ms[b % len(ms)] for b in range(B)], np.int32)
    return haps, reads, rlens, m


def build_vcf_worklist(tmpdir: str, seed: int):
    """Writes ref.fa (+ .fai), reads.bam (+ .bai) and svs.vcf under
    tmpdir: one record per event, in the INFO forms the vcf subcommand
    parses (SVTYPE=disdup / dup_inv with insert_point=, and
    Other=ab/ab_aab/ab_<chrom>:<s>:<m>:<e>, block a duplicated in
    place).  Returns (fasta, bam, vcf, events) with events a list of
    (kind, start0, end0, third coordinate)."""
    rng = np.random.default_rng(seed)
    genome_len = sum(2 * (a + b) + GAP for _, a, b in VCF_EVENTS) + GAP
    ref = rng.integers(0, 4, genome_len).astype(np.uint8)
    reads, out, records, pos = [], [], [], GAP
    for n, (kind, a, b) in enumerate(VCF_EVENTS):
        s0, e0, third = pos, pos + a, pos + a + b
        block = ref[s0:e0]
        if kind == "DISDUP":      # a b a: block a copied to `third`
            donor = np.concatenate([ref[:third], block, ref[third:]])
            info = (f"SVTYPE=disdup;END={e0};"
                    f"insert_point=chrE:{third}")
        elif kind == "DUP_INV":   # a b a^: inverted copy at `third`
            donor = np.concatenate([ref[:third], _revcomp(block),
                                    ref[third:]])
            info = (f"SVTYPE=dup_inv;END={e0};"
                    f"insert_point=chrE:{third}")
        else:                     # ab -> aab over blocks a = [s0, e0), b
            donor = np.concatenate([ref[:e0], block, ref[e0:]])
            info = (f"SVTYPE=cannot_classify;END={third};"
                    f"Other=ab/ab_aab/ab_chrE:{s0}:{e0}:{third}")
        # the scorers' read windows end past the event by one block
        read_len = (third - s0) + a + 2 * FLANK + LEAD + 1000
        reads += [(0, *r) for r in _span_reads(ref, donor, s0, read_len,
                                                rng)]
        records.append(f"chrE\t{s0 + 1}\t{kind.lower()}{n}\tN\t<SV>\t99"
                       f"\tPASS\t{info}\tGT\t0/1")
        out.append((kind, s0, e0, third))
        pos = third + a + GAP
    fa, bam = _write(tmpdir, [ref], reads)
    vcf = os.path.join(tmpdir, "svs.vcf")
    with open(vcf, "w") as fh:
        fh.write("\n".join([
            "##fileformat=VCFv4.2",
            f"##contig=<ID=chrE,length={genome_len}>",
            '##INFO=<ID=END,Number=1,Type=Integer,Description="End">',
            '##INFO=<ID=SVTYPE,Number=1,Type=String,Description="Type">',
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1",
            *records]) + "\n")
    return fa, bam, vcf, out
