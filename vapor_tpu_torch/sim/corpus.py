"""The ten-class truth corpus and the repeat-heavy refiner haps.

The reference ships pre-generated per-chromosome het/homo truth sets as
its accuracy corpus (simulate/Structural_Variants_{het,homo}/, generator
semantics generateVariantChromosomes.py:184-303).  ``build_corpus`` is
the equivalent on the built-in simulator: a spec-driven truth set over
several contigs (sim/truthset.py), donor haplotypes, spanning long reads
around every breakpoint (het = half donor / half reference, homo = all
donor) and deliberate FALSE calls in SV-free regions, written as a
FASTA, a BAM and a VCF that the vcf subcommand routes class by class.
``parse_annotated`` reads the annotated VCF back and ``evaluate`` scores
per-class sensitivity and false-validation rate.

``repeat_cases`` makes the haplotypes with embedded tandem-repeat arrays
that reach the window refiner's (0.1, 0.5) band (its host QC leg).

The library part of the JAX package's accuracy and refiner-band scripts,
copied draw for draw: every builder consumes one ``random.Random(seed)``
per base, so the same seed writes the same bytes as the JAX package's.
"""
from __future__ import annotations

import os
import random
from typing import List, Tuple

from ..io.bam import BamRecord, write_bam
from ..io.fasta import write_fasta
from .scale import READ_LEN
from .truthset import SVSpec, apply_svs, place_svs, write_truth_vcf

GS_CFF = 0.3          # supporting-read fraction that counts as "validated"


def _noisy(template, rng, err=0.05):
    out = []
    for ch in template:
        x = rng.random()
        if x < err / 3:
            out.append(rng.choice("ACGT"))
        elif x < 2 * err / 3:
            out.append(rng.choice("ACGT"))
            out.append(ch)
        elif x < err:
            continue
        else:
            out.append(ch)
    return "".join(out)


def build_corpus(d, zygosity, n_contigs, contig_len, seed):
    """Returns (fa, bam, vcf, truth: {svid: class or 'FALSE_<type>'})."""
    rng = random.Random(seed)
    # all ten reference edit classes; counts per contig.  buffer 4000
    # spreads dis_dup/dup_inv insert points out to ~12 kb so the
    # corpus covers both regimes: insertion-point fallback (< 10 kb,
    # evaluable for dis_dup; NA for dup_inv — the reference's
    # premature run_flag, pyx:1604-1613) and junction mode (> 10 kb,
    # evaluable for all)
    spec = [SVSpec("del", (100, 1000), 5),
            SVSpec("inv", (100, 1000), 5),
            SVSpec("tan_dup", (100, 600), 4),
            SVSpec("dis_dup", (100, 500), 3),
            SVSpec("ins", (100, 500), 4),
            SVSpec("del_inv", (100, 500), 3),
            SVSpec("dup_inv", (100, 500), 3),
            SVSpec("dup_inv_ins", (100, 500), 3),
            SVSpec("del_dup", (300, 600), 3),
            SVSpec("del_dup_inv", (300, 600), 3)]
    genome = {}
    refs = []
    all_records = []
    truth = {}
    vcf_body = []
    contig_lengths = {}
    sv_counter = 0
    fp_counter = 0
    for ci in range(n_contigs):
        chrom = f"chr{ci + 1}"
        ref = "".join(rng.choice("ACGT") for _ in range(contig_len))
        genome[chrom] = ref
        refs.append((chrom, contig_len))
        contig_lengths[chrom] = contig_len
        svs = place_svs(contig_len, chrom, spec, rng, buffer=4000)
        donor = apply_svs(ref, svs, rng, micro_indel_rate=0.0)
        all_edits = sorted(e for sv in svs for e in sv.info["edits"])

        def donor_pos(p):
            return p + sum(dl for pos, dl in all_edits if pos < p)

        reads = []
        for sv in svs:
            anchors = {sv.start0}
            if "insert_point" in sv.info:
                anchors.add(sv.info["insert_point"])
            for anchor in anchors:
                for i in range(12):
                    from_donor = zygosity == "homo" or i % 2 == 0
                    if from_donor:
                        start_d = donor_pos(anchor) - rng.randint(
                            1000, 1500)
                        template = donor[start_d:start_d + READ_LEN]
                        pos0 = start_d - (donor_pos(anchor) - anchor)
                    else:
                        pos0 = anchor - rng.randint(1000, 1500)
                        template = ref[pos0:pos0 + READ_LEN]
                    reads.append((pos0, _noisy(template, rng)))
        # deliberate false calls in SV-free stretches (reads = pure ref)
        taken = [(min(sv.start0, sv.info.get("insert_point",
                                             sv.start0)) - 4000,
                  max(sv.end0, sv.info.get("insert_point",
                                           sv.end0)) + 4000)
                 for sv in svs]
        fp_here = 0
        for _attempt in range(300):
            if fp_here >= 6:
                break
            size = rng.randint(150, 600)
            s = rng.randint(4000, contig_len - 4000 - size)
            if any(s - 2500 < e and s + size + 2500 > b
                   for b, e in taken):
                continue
            taken.append((s, s + size))
            fptype = ("DEL", "INV", "DUP")[fp_counter % 3]
            svid = f"fp{fp_counter}"
            fp_counter += 1
            fp_here += 1
            truth[svid] = f"FALSE_{fptype}"
            vcf_body.append(
                f"{chrom}\t{s + 1}\t{svid}\tN\t<SV>\t99\tPASS\t"
                f"SVTYPE={fptype};END={s + size}\tGT\t0/1")
            for i in range(12):
                pos0 = s - rng.randint(1000, 1500)
                reads.append((pos0, _noisy(ref[pos0:pos0 + READ_LEN],
                                           rng)))
        reads.sort(key=lambda r: r[0])
        base = len(all_records)
        all_records += [
            BamRecord(name=f"{chrom}_r{base + i}", flag=0, ref_id=ci,
                      pos0=p, mapq=60, cigar=f"{len(s)}M", seq=s,
                      qual=b"")
            for i, (p, s) in enumerate(reads)]
        # truth VCF rows for this contig (ids unique across contigs)
        tmp_vcf = os.path.join(d, f"_{chrom}.vcf")
        write_truth_vcf(tmp_vcf, svs, {chrom: contig_len})
        for line in open(tmp_vcf):
            if line.startswith("#"):
                continue
            cols = line.rstrip("\n").split("\t")
            svid = f"sv{sv_counter}"
            sv_counter += 1
            klass = svs[int(cols[2][2:])].svtype
            truth[svid] = klass
            cols[2] = svid
            vcf_body.append("\t".join(cols))
        os.remove(tmp_vcf)

    fa = os.path.join(d, f"ref_{zygosity}.fa")
    write_fasta(fa, genome)
    bam = os.path.join(d, f"reads_{zygosity}.bam")
    write_bam(bam, refs, all_records)
    header = ["##fileformat=VCFv4.2"]
    header += [f"##contig=<ID={c},length={ln}>"
               for c, ln in contig_lengths.items()]
    header += ['##INFO=<ID=END,Number=1,Type=Integer,Description="E">',
               '##INFO=<ID=SVTYPE,Number=1,Type=String,Description="T">',
               "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT"
               "\tS"]
    vcf = os.path.join(d, f"calls_{zygosity}.vcf")
    with open(vcf, "w") as fo:
        fo.write("\n".join(header + vcf_body) + "\n")
    return fa, bam, vcf, truth


def parse_annotated(vcf_vapor):
    """{svid: {'gs': float|None, 'gt': str, 'qs': float|None}} from the
    annotated VCF (QS recomputed as mean positive REC, exactly
    organize_result's formula)."""
    out = {}
    for line in open(vcf_vapor):
        if line.startswith("#") or not line.strip():
            continue
        cols = line.rstrip("\n").split("\t")
        info = {}
        for f in cols[7].split(";"):
            if "=" in f:
                k, v = f.split("=", 1)
                info[k] = v
        rec = info.get("VaPor_REC")
        gs = info.get("VaPor_GS")
        qs = None
        if rec and rec not in ("NA",):
            vals = [float(x) for x in rec.split(",") if x]
            pos = [v for v in vals if v > 0]
            qs = sum(pos) / len(pos) if pos else None
        out[cols[2]] = {
            "gs": None if gs in (None, "NA") else float(gs),
            "gt": info.get("VaPor_GT"),
            "qs": qs,
        }
    return out


def evaluate(results, truth):
    per_class = {}
    for svid, klass in truth.items():
        r = results.get(svid)
        c = per_class.setdefault(klass, {
            "n": 0, "evaluated": 0, "validated": 0, "gs": []})
        c["n"] += 1
        if r is None or r["gs"] is None:
            continue
        c["evaluated"] += 1
        c["gs"].append(round(r["gs"], 3))
        if r["gs"] >= GS_CFF:
            c["validated"] += 1
    summary = {}
    for klass, c in sorted(per_class.items()):
        is_false = klass.startswith("FALSE")
        rate = c["validated"] / c["n"] if c["n"] else None
        summary[klass] = {
            "n": c["n"],
            "evaluated": c["evaluated"],
            ("false_validation_rate" if is_false else "sensitivity"):
                round(rate, 3),
            "gs_values": sorted(c["gs"]),
        }
    return summary


def repeat_hap(rng: random.Random, span: int, period: int,
               rep_frac: float, noise: float = 0.05) -> str:
    """flank + (noisy tandem array | random) + flank, like a DUP/DEL
    haplotype whose body overlaps a repeat family."""
    unit = "".join(rng.choice("ACGT") for _ in range(period))
    n_rep = max(2, int(span * rep_frac / period))
    arr = []
    for _ in range(n_rep):
        arr.append("".join(
            rng.choice("ACGT") if rng.random() < noise else ch
            for ch in unit))
    body = "".join(arr)
    rest = span - len(body)
    left = "".join(rng.choice("ACGT") for _ in range(500 + rest // 2))
    right = "".join(rng.choice("ACGT")
                    for _ in range(500 + rest - rest // 2))
    return left + body + right


def repeat_cases(seed: int = 99) -> List[Tuple[int, float, int, str]]:
    """The 108 (period, repeat fraction, span, hap) cases of the
    refiner-band census: periods 15/40/100, repeat fractions 0.2-0.8 of
    spans 600/1200/2400, three haps each, drawn in order from one
    random.Random(seed)."""
    rng = random.Random(seed)
    cases = []
    for period in (15, 40, 100):
        for rep_frac in (0.2, 0.4, 0.6, 0.8):
            for span in (600, 1200, 2400):
                for _ in range(3):
                    cases.append((period, rep_frac, span,
                                  repeat_hap(rng, span, period, rep_frac)))
    return cases

