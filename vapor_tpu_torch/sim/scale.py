"""Scale-fixture builder: multi-contig genome + truth SVs + targeted
long reads + worklist, for throughput runs and the scatter e2e test.

The reference's scale harness is the WDL per-contig scatter over a real
genome (wdl/VaPoRVcf.wdl:44-77); this builds the equivalent synthetic
input at any size: per-contig truth sets (sim.truthset placement), het
donor/reference read mixes around every breakpoint, plus deliberate
false calls in SV-free regions.  A copy of the JAX package's module:
the same seed writes the same bytes.  (The port's own numpy worklists
are in sim/worklists.py.)
"""
from __future__ import annotations

import random
from typing import Dict, List, Tuple

from ..io.bam import BamRecord, write_bam
from ..io.fasta import write_fasta
from .truthset import SVSpec, PlacedSV, apply_svs, place_svs

READ_LEN = 2400


def build_event_worklist(tmpdir: str, n_events: int,
                         spacing: int = 15000, span: int = 300,
                         read_len: int = 2600, seed: int = 9,
                         spans=None, reads_each: int = 8):
    """Single-contig worklist of evenly spaced DEL/INV/DUP events with
    het donor/reference spanning reads — the e2e throughput fixture.
    ``spans`` cycles per-event spans (e.g. 400/900/1400 bp bodies);
    ``reads_each`` is the donor and reference read count per event.
    Returns (fasta, bam, bed)."""
    from .synth import apply_sv, random_genome, simulate_reads
    rng = random.Random(seed)
    contig = "chrE"
    genome_len = spacing * (n_events + 1)
    genome = random_genome(genome_len, seed=seed, name=contig)
    ref = genome[contig]
    reads = []
    bed_lines = []
    for i in range(n_events):
        svtype = ("DEL", "INV", "DUP")[i % 3]
        s0 = spacing * (i + 1)
        e0 = s0 + (spans[i % len(spans)] if spans else span)
        hap = apply_sv(ref, svtype, s0, e0)
        window = (max(0, s0 - 2200), s0 - 600)
        reads += simulate_reads(ref, hap, reads_each, read_len, rng,
                                0.06, region=window, from_donor=True)
        reads += simulate_reads(ref, ref, reads_each, read_len, rng,
                                0.06, region=window, from_donor=False)
        bed_lines.append(f"{contig}\t{s0}\t{e0}\tSV{i}\t{svtype}")
    reads.sort(key=lambda r: r[0])
    records = [
        BamRecord(name=f"r{i}", flag=0, ref_id=0, pos0=pos, mapq=60,
                  cigar=cigar, seq=seq, qual=b"")
        for i, (pos, seq, cigar) in enumerate(reads)]
    fa = f"{tmpdir}/ref.fa"
    bam = f"{tmpdir}/reads.bam"
    bed = f"{tmpdir}/svs.bed"
    write_fasta(fa, genome)
    write_bam(bam, [(contig, genome_len)], records)
    from ..io.bai import write_bai
    write_bai(bam)
    with open(bed, "w") as fh:
        fh.write("\n".join(bed_lines) + "\n")
    return fa, bam, bed


def _noisy(template: str, rng: random.Random, err: float = 0.05) -> str:
    """Apply substitution/insertion/deletion noise at rate ``err``
    (err/3 each), vectorized: the per-character Python loop dominated
    large fixture builds (~300 s of a 24x400 kb capstone build).
    Deterministic per caller rng (stream derived via getrandbits)."""
    import numpy as np
    n = len(template)
    if n == 0:
        return template
    g = np.random.default_rng(rng.getrandbits(64))
    arr = np.frombuffer(template.encode("ascii"), np.uint8)
    x = g.random(n)
    # 0 = substitute, 1 = insert-before, 2 = delete, 3 = keep
    cat = np.digitize(x, [err / 3, 2 * err / 3, err]).astype(np.int8)
    counts = np.ones(n, np.int64)
    counts[cat == 1] = 2
    counts[cat == 2] = 0
    starts = np.cumsum(counts) - counts
    out = np.empty(int(counts.sum()), np.uint8)
    bases = np.frombuffer(b"ACGT", np.uint8)
    keep = cat == 3
    out[starts[keep]] = arr[keep]
    sub = cat == 0
    out[starts[sub]] = bases[g.integers(0, 4, int(sub.sum()))]
    ins = cat == 1
    out[starts[ins]] = bases[g.integers(0, 4, int(ins.sum()))]
    out[starts[ins] + 1] = arr[ins]
    return out.tobytes().decode("ascii")


def _donor_shift(svs: List[PlacedSV], p: int) -> int:
    """Reference pos -> donor pos delta for events fully upstream."""
    shift = 0
    for sv in svs:
        if sv.end0 <= p:
            if sv.svtype == "del":
                shift -= sv.end0 - sv.start0
            elif sv.svtype == "tan_dup":
                times = sv.info.get("times", 2)
                shift += (times - 1) * (sv.end0 - sv.start0)
    return shift


def build_scale_case(tmpdir: str, n_contigs: int = 2,
                     contig_len: int = 60000, events_per: int = 8,
                     reads_per: int = 10, n_false_per: int = 2,
                     seed: int = 77) -> Dict:
    """Write ref.fa + reads.bam + calls.bed spanning n_contigs; returns
    paths plus per-call truth labels keyed by SVID."""
    rng = random.Random(seed)
    genome: Dict[str, str] = {}
    refs: List[Tuple[str, int]] = []
    all_records: List[Tuple[str, int, str]] = []
    bed_rows: List[str] = []
    truth: Dict[str, bool] = {}
    per = max(1, events_per // 3)
    for ci in range(n_contigs):
        chrom = f"chr{ci + 1}"
        ref = "".join(rng.choice("ACGT") for _ in range(contig_len))
        genome[chrom] = ref
        refs.append((chrom, contig_len))
        spec = [SVSpec("del", (150, 700), per),
                SVSpec("inv", (150, 700), per),
                SVSpec("tan_dup", (150, 500), per)]
        svs = place_svs(contig_len, chrom, spec, rng, buffer=3000)
        donor = apply_svs(ref, svs, rng, micro_indel_rate=0.0)
        label = {"del": "DEL", "inv": "INV", "tan_dup": "DUP"}
        for i, sv in enumerate(svs):
            svid = f"{chrom}_true{i}"
            bed_rows.append(f"{chrom}\t{sv.start0}\t{sv.end0}\t{svid}\t"
                            f"{label[sv.svtype]}\n")
            truth[svid] = True
            for r in range(reads_per):
                if r % 2 == 0:
                    start_d = sv.start0 + _donor_shift(svs, sv.start0) \
                        - rng.randint(1000, 1600)
                    template = donor[max(0, start_d):
                                     max(0, start_d) + READ_LEN]
                    pos0 = max(0, start_d - _donor_shift(svs, sv.start0))
                else:
                    pos0 = max(0, sv.start0 - rng.randint(1000, 1600))
                    template = ref[pos0:pos0 + READ_LEN]
                if len(template) < 300:
                    continue
                all_records.append((chrom, pos0, _noisy(template, rng)))
        # false calls with reference-only coverage
        placed_false = 0
        probe = 5000
        while placed_false < n_false_per and probe < contig_len - 5000:
            if all(abs(probe - sv.start0) > 3000 for sv in svs):
                svid = f"{chrom}_false{placed_false}"
                bed_rows.append(f"{chrom}\t{probe}\t{probe + 300}\t"
                                f"{svid}\tDEL\n")
                truth[svid] = False
                for _ in range(max(6, reads_per // 2)):
                    pos0 = probe - rng.randint(1000, 1600)
                    all_records.append(
                        (chrom, pos0,
                         _noisy(ref[pos0:pos0 + READ_LEN], rng)))
                placed_false += 1
            probe += 4000
    order = {c: i for i, (c, _) in enumerate(refs)}
    all_records.sort(key=lambda r: (order[r[0]], r[1]))
    fa = f"{tmpdir}/ref.fa"
    write_fasta(fa, genome)
    bam = f"{tmpdir}/reads.bam"
    write_bam(bam, refs, [
        BamRecord(f"r{i}", 0, order[c], p, 60, f"{len(s)}M", s, b"")
        for i, (c, p, s) in enumerate(all_records)])
    from ..io.bai import write_bai
    write_bai(bam)
    bed = f"{tmpdir}/calls.bed"
    with open(bed, "w") as fo:
        fo.writelines(bed_rows)
    return {"fasta": fa, "bam": bam, "bed": bed, "truth": truth,
            "n_events": len(truth), "n_reads": len(all_records)}
