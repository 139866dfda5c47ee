"""Synthetic bed worklist: one contig, DEL and INV calls, noisy long reads.

Made from a seed with numpy and written with the package's own FASTA,
BAM and BAI writers, so a run needs no external genome.  Every event gets
`reads_each` spanning reads, half from the donor haplotype (carrying the
SV) and half from the reference (a het call), with PacBio-like noise:
substitutions, insertions and deletions in equal parts at rate `err`.
Reference reads carry CIGARs that follow their indels; donor reads carry
an all-M CIGAR, which the read clipper only uses to find the window
entry point.
"""
from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np

from ..io.bai import write_bai
from ..io.bam import BamRecord, write_bam
from ..io.fasta import write_fasta

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_OPS = "MID"


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


def event_layout(bodies: Sequence[int], reps: int, big: int
                 ) -> List[Tuple[str, int]]:
    """(svtype, body) of every event: DEL and INV at each body, `reps`
    times, then one DEL and one INV of `big` bp (junction mode)."""
    out = [(t, body) for body in bodies for _ in range(reps)
           for t in ("DEL", "INV")]
    return out + [("DEL", big), ("INV", big)]


def build_event_worklist(tmpdir: str, seed: int,
                         bodies: Sequence[int] = (400, 900, 1400, 3000,
                                                  6000, 9500),
                         reps: int = 2, big: int = 25000,
                         reads_each: int = 20, err: float = 0.08,
                         flank: int = 500, lead: int = 1500):
    """Writes ref.fa (+ .fai), reads.bam (+ .bai) and svs.bed under
    tmpdir.  Returns (fasta, bam, bed, events) with events a list of
    (svtype, start0, end0)."""
    rng = np.random.default_rng(seed)
    layout = event_layout(bodies, reps, big)
    gap = 2 * lead + 2 * flank + 2000
    genome_len = sum(body + gap for _, body in layout) + gap
    ref = rng.integers(0, 4, genome_len).astype(np.uint8)
    reads, events, pos = [], [], gap
    for svtype, body in layout:
        s0, e0 = pos, pos + body
        pos = e0 + gap
        if svtype == "DEL":
            donor = np.concatenate([ref[:s0], ref[e0:]])
        else:
            donor = np.concatenate([ref[:s0], _revcomp(ref[s0:e0]),
                                    ref[e0:]])
        # whole-event mode needs reads through e0 + flank; junction mode
        # only around s0
        span = body if body < 10000 else 0
        read_len = span + 2 * flank + lead + 1000
        for r in range(reads_each):
            start = int(rng.integers(s0 - flank - lead, s0 - flank - 100))
            from_donor = r % 2 == 0
            template = (donor if from_donor else ref)[start:start + read_len]
            seq, cigar = noisy_read(template, rng, err)
            if from_donor:
                cigar = f"{seq.size}M"
            reads.append((start, seq, cigar))
        events.append((svtype, s0, e0))
    reads.sort(key=lambda x: x[0])
    contig = "chrE"
    records = [BamRecord(name=f"r{i}", flag=0, ref_id=0, pos0=p, mapq=60,
                         cigar=cigar, seq=BASES[seq].tobytes().decode(),
                         qual=b"")
               for i, (p, seq, cigar) in enumerate(reads)]
    fa = os.path.join(tmpdir, "ref.fa")
    bam = os.path.join(tmpdir, "reads.bam")
    bed = os.path.join(tmpdir, "svs.bed")
    write_fasta(fa, {contig: BASES[ref].tobytes().decode()})
    write_bam(bam, [(contig, genome_len)], records)
    write_bai(bam)
    with open(bed, "w") as fh:
        fh.write("".join(f"{contig}\t{s}\t{e}\tSV{i}\t{t}\n"
                         for i, (t, s, e) in enumerate(events)))
    return fa, bam, bed, events
