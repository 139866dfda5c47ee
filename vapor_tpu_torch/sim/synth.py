"""Synthetic genome / long-read / SV fixture generator.

The reference's golden BAM is an out-of-band download
(vapor_test/README.md), so tests synthesize their own: a random genome,
SV haplotypes (DEL/INS/INV/DUP/complex), and noisy "PacBio-like" reads
aligned back to the reference coordinates with honest CIGARs.  A copy
of the JAX package's module, Python's ``random.Random`` stream and all:
the same seed writes the same bytes.
"""
from __future__ import annotations

import random
from typing import Dict, List, Optional, Tuple

from ..io.bam import BamRecord, write_bam
from ..io.fasta import write_fasta, reverse_complement

BASES = "ACGT"


def random_genome(length: int, seed: int = 0, name: str = "chrS"
                  ) -> Dict[str, str]:
    rng = random.Random(seed)
    return {name: "".join(rng.choice(BASES) for _ in range(length))}


def apply_sv(ref: str, svtype: str, start0: int, end0: int,
             ins_seq: str = "", dup_count: int = 2) -> str:
    """Return the donor haplotype for a single SV on ``ref``.

    Coordinates are 0-based half-open over the reference contig.
    """
    body = ref[start0:end0]
    if svtype == "DEL":
        return ref[:start0] + ref[end0:]
    if svtype == "INV":
        return ref[:start0] + reverse_complement(body) + ref[end0:]
    if svtype == "DUP":
        return ref[:start0] + body * dup_count + ref[end0:]
    if svtype == "INS":
        return ref[:start0] + ins_seq + ref[start0:]
    raise ValueError(f"unknown svtype {svtype}")


def mutate_read(seq: str, rng: random.Random, err: float = 0.08
                ) -> Tuple[str, str]:
    """PacBio-like noise (mismatch/ins/del in ~1:1:1) + matching CIGAR.

    The CIGAR is relative to the *template* the read was copied from, so
    reads simulated from the reference haplotype align back with honest
    M/I/D runs; donor-haplotype reads are given a fully-M CIGAR over
    their aligned prefix (a deliberate simplification: VaPoR only uses
    POS + CIGAR to find the window entry point, pyx:309-337).
    """
    out = []
    ops: List[str] = []
    for ch in seq:
        r = rng.random()
        if r < err / 3:                       # mismatch
            out.append(rng.choice([b for b in BASES if b != ch]))
            ops.append("M")
        elif r < 2 * err / 3:                 # insertion before base
            out.append(rng.choice(BASES))
            ops.append("I")
            out.append(ch)
            ops.append("M")
        elif r < err:                         # deletion
            ops.append("D")
        else:
            out.append(ch)
            ops.append("M")
    cigar = _runlength(ops)
    return "".join(out), cigar


def _runlength(ops: List[str]) -> str:
    parts = []
    prev, count = None, 0
    for op in ops:
        if op == prev:
            count += 1
        else:
            if prev is not None:
                parts.append(f"{count}{prev}")
            prev, count = op, 1
    if prev is not None:
        parts.append(f"{count}{prev}")
    return "".join(parts)


def simulate_reads(ref: str, hap: str, n_reads: int, read_len: int,
                   rng: random.Random, err: float = 0.08,
                   region: Optional[Tuple[int, int]] = None,
                   from_donor: bool = True) -> List[Tuple[int, str, str]]:
    """Sample reads (pos0, seq, cigar) from the donor or reference hap.

    Donor reads get all-M CIGARs anchored at a reference position chosen
    so the read enters the window from the left flank (VaPoR requires
    POS <= window start, pyx:345).
    """
    lo, hi = region if region else (0, len(ref) - read_len)
    out = []
    for _ in range(n_reads):
        if from_donor:
            start = rng.randint(max(0, lo), max(0, min(hi, len(hap) - read_len)))
            template = hap[start:start + read_len]
            seq, _ = mutate_read(template, rng, err)
            cigar = f"{len(seq)}M"
            out.append((start, seq, cigar))
        else:
            start = rng.randint(max(0, lo), max(0, min(hi, len(ref) - read_len)))
            template = ref[start:start + read_len]
            seq, cigar = mutate_read(template, rng, err)
            out.append((start, seq, cigar))
    return out


def build_test_case(tmpdir: str, genome_len: int = 30000, seed: int = 7,
                    sv: Tuple[str, int, int] = ("DEL", 14000, 14400),
                    n_donor: int = 8, n_ref: int = 8,
                    read_len: int = 3000, err: float = 0.06,
                    het: bool = True) -> Dict[str, str]:
    """Write ref.fa + reads.bam containing one SV; return paths + meta."""
    rng = random.Random(seed)
    contig = "chrS"
    genome = random_genome(genome_len, seed=seed, name=contig)
    ref = genome[contig]
    svtype, s0, e0 = sv
    hap = apply_sv(ref, svtype, s0, e0)

    window = (max(0, s0 - 2500), s0)
    reads = []
    reads += simulate_reads(ref, hap, n_donor, read_len, rng, err,
                            region=window, from_donor=True)
    if het:
        reads += simulate_reads(ref, ref, n_ref, read_len, rng, err,
                                region=window, from_donor=False)
    reads.sort(key=lambda r: r[0])

    records = [
        BamRecord(name=f"read{i}", flag=0, ref_id=0, pos0=pos, mapq=60,
                  cigar=cigar, seq=seq, qual=b"")
        for i, (pos, seq, cigar) in enumerate(reads)
    ]
    fa = f"{tmpdir}/ref.fa"
    bam = f"{tmpdir}/reads.bam"
    write_fasta(fa, genome)
    write_bam(bam, [(contig, genome_len)], records)
    return {"fasta": fa, "bam": bam, "contig": contig,
            "svtype": svtype, "start0": s0, "end0": e0}
