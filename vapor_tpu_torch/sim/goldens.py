"""The golden cases: input builders and CLI runners for fixtures/golden/.

Each golden of ``fixtures/golden/`` is the output of one CLI run on a
small synthetic case: four bed cases, the junction-mode bed case, the
vcf case of every SV type (plain TSV and annotated VCF), the vcf
fallback branches, a svelter case and a MELT ins case.  The builders
here are copies of the JAX package's (tests/golden_cases.py), draw for
draw: every builder consumes its ``random.Random`` in the same order,
so the same case writes the same FASTA, index, BAM and call-set bytes.

The runners call this package's CLI with a backend and a device and
return the output text; ``check_goldens`` runs every case (or the named
ones) and compares each output with its golden byte for byte, counting
the kernel launches of each run.
"""
from __future__ import annotations

import contextlib
import os
import random
import shutil
import tempfile
import time
from typing import Callable, Dict, Iterable, Optional

from ..io.bam import BamRecord, write_bam
from ..io.fasta import reverse_complement, write_fasta

READ_LEN = 1700
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "fixtures", "golden")


def _noisy(t, rng):
    out = []
    for ch in t:
        x = rng.random()
        if x < 0.02:
            out.append(rng.choice("ACGT"))
        elif x < 0.04:
            out.append(rng.choice("ACGT"))
            out.append(ch)
        elif x < 0.06:
            continue
        else:
            out.append(ch)
    return "".join(out)


def _span_reads(ref, donor, anchor0, rng, n=8, lo=1500, hi=900):
    """Spanning reads entering the window left of anchor0 (half donor,
    half reference)."""
    out = []
    for i in range(n):
        src = donor if i % 2 == 0 else ref
        start = rng.randint(max(0, anchor0 - lo), max(1, anchor0 - hi))
        out.append((start, _noisy(src[start:start + READ_LEN], rng)))
    return out


def _write_sorted_bam(path, contig, length, reads):
    reads.sort(key=lambda r: r[0])
    write_bam(path, [(contig, length)], [
        BamRecord(name=f"r{i}", flag=0, ref_id=0, pos0=p, mapq=60,
                  cigar=f"{len(s)}M", seq=s, qual=b"")
        for i, (p, s) in enumerate(reads)])


def _write_vcf(path, contig, genome_len, sample, records):
    lines = ["##fileformat=VCFv4.2",
             f"##contig=<ID={contig},length={genome_len}>",
             '##INFO=<ID=END,Number=1,Type=Integer,Description="E">',
             '##INFO=<ID=SVTYPE,Number=1,Type=String,Description="T">',
             f"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
             f"{sample}"]
    for chrom, pos, vid, info in records:
        lines.append(f"{chrom}\t{pos}\t{vid}\tN\t<SV>\t99\tPASS\t{info}"
                     f"\tGT\t0/1")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


# -- bed mode -----------------------------------------------------------------

BED_CASES = [
    ("DEL", 6000, 6300, 11, True),
    ("DEL", 6000, 6200, 12, False),
    ("INV", 6000, 6350, 13, True),
    ("DUP", 6000, 6250, 14, False),
]


def build_bed_case(d: str, svtype, s0, e0, seed, het):
    from .synth import build_test_case
    case = build_test_case(d, genome_len=14000, sv=(svtype, s0, e0),
                           n_donor=6, n_ref=6 if het else 0,
                           read_len=1700, err=0.07, seed=seed, het=het)
    bed = os.path.join(d, "svs.bed")
    with open(bed, "w") as fo:
        fo.write(f"chrS\t{s0}\t{e0}\tSV1\t{svtype}\n")
    return {"fasta": case["fasta"], "bam": case["bam"], "bed": bed}


# -- vcf mode, all SV types ---------------------------------------------------

def build_vcf_case(d: str):
    rng = random.Random(77)
    genome_len = 40000
    ref = "".join(rng.choice("ACGT") for _ in range(genome_len))
    contig = "chrS"
    reads = []
    records = []

    def add_reads(donor, anchor):
        reads.extend(_span_reads(ref, donor, anchor, rng))

    # DEL 4000-4300
    add_reads(ref[:4000] + ref[4300:], 4000)
    records.append(("chrS", 4001, "d1", "SVTYPE=DEL;END=4300"))
    # INV 8000-8350
    add_reads(ref[:8000] + reverse_complement(ref[8000:8350])
              + ref[8350:], 8000)
    records.append(("chrS", 8001, "v1", "SVTYPE=INV;END=8350"))
    # TANDUP 12000-12250
    add_reads(ref[:12250] + ref[12000:12250] + ref[12250:], 12000)
    records.append(("chrS", 12001, "t1", "SVTYPE=DUP;END=12250"))
    # INS with explicit sequence at 16000
    ins_seq = "".join(rng.choice("ACGT") for _ in range(260))
    add_reads(ref[:16000] + ins_seq + ref[16000:], 16000)
    records.append(("chrS", 16001, "i1",
                    f"SVTYPE=INS;END=16001;SVLEN=260;SEQ={ins_seq}"))
    # INS unknown sequence (X-run) at 19000
    ins2 = "".join(rng.choice("ACGT") for _ in range(180))
    add_reads(ref[:19000] + ins2 + ref[19000:], 19000)
    records.append(("chrS", 19001, "i2",
                    "SVTYPE=INS;END=19001;SVLEN=180"))
    # DISDUP: dup 22000-22200 inserted at 23000 (a b a)
    add_reads(ref[:23000] + ref[22000:22200] + ref[23000:], 22000)
    records.append(("chrS", 22001, "dd1",
                    "SVTYPE=disdup;END=22200;insert_point=chrS:23000"))
    # DUP_INV: dup 26000-26150 inverted-inserted at 27000
    add_reads(ref[:27000] + reverse_complement(ref[26000:26150])
              + ref[27000:], 26000)
    records.append(("chrS", 26001, "di1",
                    "SVTYPE=dup_inv;END=26150;insert_point=chrS:27000"))
    # DEL_INV: del 30000-30200 + inv 30200-30350 (adjacent)
    add_reads(ref[:30000] + reverse_complement(ref[30200:30350])
              + ref[30350:], 30000)
    records.append(("chrS", 30001, "dv1",
                    "SVTYPE=del_inv;END=30350;"
                    "del=chrS:30000-30200;inv=chrS:30200-30350"))
    # Other: ab/ab -> ab/ba block swap at 34000/34150/34300
    add_reads(ref[:34000] + ref[34150:34300] + ref[34000:34150]
              + ref[34300:], 34000)
    records.append(("chrS", 34001, "o1",
                    "SVTYPE=cannot_classify;END=34300;"
                    "Other=ab/ab_ab/ba_chrS:34000:34150:34300"))
    # sub-50bp DEL and INV -> NA rows
    records.append(("chrS", 37001, "s1", "SVTYPE=DEL;END=37030"))
    records.append(("chrS", 37501, "s2", "SVTYPE=INV;END=37530"))

    fa = os.path.join(d, "ref.fa")
    write_fasta(fa, {contig: ref})
    bam = os.path.join(d, "reads.bam")
    _write_sorted_bam(bam, contig, genome_len, reads)
    vcf = os.path.join(d, "svs.vcf")
    _write_vcf(vcf, contig, genome_len, "S1", records)
    return {"dir": d, "fasta": fa, "bam": bam, "vcf": vcf}


# -- junction/breakpoint mode -------------------------------------------------

def _junction_reads(ref, donor_junction_seq, anchor0, rng, n=8):
    out = []
    for i in range(n):
        start = rng.randint(anchor0 - 1400, anchor0 - 900)
        if i % 2 == 0:
            offset = start - (anchor0 - 1400)
            template = donor_junction_seq[offset:offset + READ_LEN]
        else:
            template = ref[start:start + READ_LEN]
        out.append((start, _noisy(template, rng)))
    return out


def build_big_case(d: str):
    rng = random.Random(404)
    genome_len = 70000
    ref = "".join(rng.choice("ACGT") for _ in range(genome_len))
    reads = []
    # big DEL 15000-40000 (span 25k > 10k -> junction mode)
    del_s, del_e = 15000, 40000
    donor = ref[:del_s] + ref[del_e:]
    start_region = del_s - 1400
    reads += _junction_reads(
        ref, donor[start_region:start_region + 6000], del_s, rng)
    # big INV 48000-62000
    inv_s, inv_e = 48000, 62000
    donor2 = ref[:inv_s] + reverse_complement(ref[inv_s:inv_e]) + \
        ref[inv_e:]
    start_region = inv_s - 1400
    reads += _junction_reads(
        ref, donor2[start_region:start_region + 6000], inv_s, rng)

    fa = os.path.join(d, "ref.fa")
    write_fasta(fa, {"chrS": ref})
    bam = os.path.join(d, "reads.bam")
    _write_sorted_bam(bam, "chrS", genome_len, reads)
    bed = os.path.join(d, "svs.bed")
    with open(bed, "w") as fo:
        fo.write(f"chrS\t{del_s}\t{del_e}\tBIG1\tDEL\n")
        fo.write(f"chrS\t{inv_s}\t{inv_e}\tBIG2\tINV\n")
    return {"fasta": fa, "bam": bam, "bed": bed, "dir": d}


# -- validator fallback branches ----------------------------------------------

def build_fb_case(d: str):
    rng = random.Random(808)
    genome_len = 80000
    ref = "".join(rng.choice("ACGT") for _ in range(genome_len))
    reads = []
    records = []

    # DISDUP span > 10k: dup 5000-5200 inserted at 18000
    donor = ref[:18000] + ref[5000:5200] + ref[18000:]
    reads += _span_reads(ref, donor, 18000, rng)
    records.append(("chrS", 5001, "ddL",
                    "SVTYPE=disdup;END=5200;insert_point=chrS:18000"))
    # DUP_INV span > 10k: dup 25000-25150 inverted-inserted at 38000
    donor2 = ref[:38000] + reverse_complement(ref[25000:25150]) + \
        ref[38000:]
    reads += _span_reads(ref, donor2, 38000, rng)
    records.append(("chrS", 25001, "diL",
                    "SVTYPE=dup_inv;END=25150;insert_point=chrS:38000"))
    # long INS (>= 5000): window QC uses the ref-only branch
    ins_seq = "".join(rng.choice("ACGT") for _ in range(5200))
    donor3 = ref[:50000] + ins_seq + ref[50000:]
    reads += _span_reads(ref, donor3, 50000, rng)
    records.append(("chrS", 50001, "insL",
                    f"SVTYPE=INS;END=50001;SVLEN={len(ins_seq)};"
                    f"SEQ={ins_seq}"))
    # DISDUP read-starved whole region
    donor4 = ref[:64000] + ref[62000:62150] + ref[64000:]
    for i in range(8):
        start = rng.randint(64000 - 1400, 64000 - 1000)
        src = donor4 if i % 2 == 0 else ref
        reads.append((start, _noisy(src[start:start + READ_LEN], rng)))
    records.append(("chrS", 62001, "ddS",
                    "SVTYPE=disdup;END=62150;insert_point=chrS:64000"))

    fa = os.path.join(d, "ref.fa")
    write_fasta(fa, {"chrS": ref})
    bam = os.path.join(d, "reads.bam")
    _write_sorted_bam(bam, "chrS", genome_len, reads)
    vcf = os.path.join(d, "svs.vcf")
    _write_vcf(vcf, "chrS", genome_len, "S", records)
    return {"fasta": fa, "bam": bam, "vcf": vcf}


# -- svelter and MELT ins modes -----------------------------------------------

def build_svelter_case(d: str):
    rng = random.Random(55)
    ref = "".join(rng.choice("ACGT") for _ in range(20000))
    donor = ref[:8000] + ref[8200:]
    reads = _span_reads(ref, donor, 8000, rng)
    fa = os.path.join(d, "ref.fa")
    write_fasta(fa, {"chrS": ref})
    bam = os.path.join(d, "reads.bam")
    _write_sorted_bam(bam, "chrS", 20000, reads)
    sv = os.path.join(d, "calls.svelter")
    with open(sv, "w") as fo:
        fo.write("chr start end bps ref alt S1\n"
                 "chrS 8000 8400 chrS:8000:8200:8400 ab/ab b/ab 1\n")
    return {"fasta": fa, "bam": bam, "svelter": sv}


def build_melt_case(d: str):
    rng = random.Random(66)
    ref = "".join(rng.choice("ACGT") for _ in range(12000))
    ins_seq = "".join(rng.choice("ACGT") for _ in range(240))
    donor = ref[:6000] + ins_seq + ref[6000:]
    reads = _span_reads(ref, donor, 6000, rng)
    fa = os.path.join(d, "ref.fa")
    write_fasta(fa, {"chrM1": ref})
    bam = os.path.join(d, "reads.bam")
    _write_sorted_bam(bam, "chrM1", 12000, reads)
    prefix = os.path.join(d, "melt.sites")
    with open(prefix + ".vcf", "w") as fo:
        fo.write("##fileformat=VCFv4.2\n"
                 "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
                 f"chrM1\t6000\tmei1\tINS\t<INS:ME>\t99\tPASS\t"
                 f"SVLEN={len(ins_seq)};MEIINFO=ALU,+\n")
    write_fasta(prefix + ".fa", {"chrM1_6000": ins_seq})
    return {"fasta": fa, "bam": bam, "prefix": prefix}


# -- runners: this package's CLI on a backend and a device -------------------

def _run_cli(args, backend: str, device: str) -> None:
    from ..cli import main
    rc = main([*args, "--backend", backend, "--device", device,
               "--no-figures"])
    if rc != 0:
        raise RuntimeError(f"vapor-tpu-torch CLI exited {rc}: {args}")


def _files(mode, sv_input, case, d, figs="figs"):
    return [mode, "--sv-input", sv_input, "--reference", case["fasta"],
            "--pacbio-input", case["bam"], "--output-path",
            os.path.join(d, figs)]


def _read(path) -> str:
    with open(path) as fh:
        return fh.read()


def run_bed_case(d, case, backend="torch", device="cuda") -> str:
    out = os.path.join(d, "ours.vapor")
    _run_cli([*_files("bed", case["bed"], case, d), "--output-file", out],
             backend, device)
    return _read(out)


def run_vcf_case(d, case, backend="torch", device="cuda") -> str:
    """vcf mode with the annotate stage suppressed: the TSV alone, read
    from <sv-input>.vapor of a fresh copy of the case's VCF."""
    from .. import cli
    my_vcf = shutil.copyfile(case["vcf"], os.path.join(d, "my_svs.vcf"))
    orig = cli.annotate_vcf
    cli.annotate_vcf = lambda *a, **k: None
    try:
        _run_cli(_files("vcf", my_vcf, case, d), backend, device)
    finally:
        cli.annotate_vcf = orig
    return _read(my_vcf + ".vapor")


def run_vcf_case_annotated(d, case, backend="torch", device="cuda") -> str:
    """Full vcf mode: <sv-input>.vapor, rewritten as the annotated VCF,
    of a fresh copy of the case's VCF."""
    my_vcf = shutil.copyfile(case["vcf"], os.path.join(d, "ann_svs.vcf"))
    _run_cli(_files("vcf", my_vcf, case, d, "figs_ann"), backend, device)
    return _read(my_vcf + ".vapor")


def run_svelter_case(d, case, backend="torch", device="cuda") -> str:
    out = os.path.join(d, "ours.out")
    _run_cli([*_files("svelter", case["svelter"], case, d),
              "--output-file", out], backend, device)
    return _read(out)


def run_melt_case(d, case, backend="torch", device="cuda") -> str:
    """ins mode: takes the MELT prefix and writes prefix.vapor."""
    _run_cli(_files("ins", case["prefix"], case, d), backend, device)
    return _read(case["prefix"] + ".vapor")


# -- registry: golden name -> builder and runner -----------------------------

def _bed_builder(svtype, s0, e0, seed, het):
    return lambda d: build_bed_case(d, svtype, s0, e0, seed, het)


BUILDERS: Dict[str, Callable[[str], dict]] = {
    **{f"bed_{svtype.lower()}_{seed}": _bed_builder(svtype, s0, e0, seed,
                                                    het)
       for svtype, s0, e0, seed, het in BED_CASES},
    "vcf_all_types": build_vcf_case,
    "vcf_all_types_annotated": build_vcf_case,
    "bed_junction_big": build_big_case,
    "vcf_fallbacks": build_fb_case,
    "svelter_basic": build_svelter_case,
    "ins_melt": build_melt_case,
}
RUNNERS = {
    **{name: run_bed_case for name in BUILDERS if name.startswith("bed_")},
    "vcf_all_types": run_vcf_case,
    "vcf_all_types_annotated": run_vcf_case_annotated,
    "vcf_fallbacks": run_vcf_case,
    "svelter_basic": run_svelter_case,
    "ins_melt": run_melt_case,
}


def run_golden(name: str, d: str, backend: str = "torch",
               device: str = "cuda") -> str:
    """Builds golden `name`'s case in d and runs it; returns the output
    text."""
    return RUNNERS[name](d, BUILDERS[name](d), backend, device)


def golden_text(name: str) -> str:
    return _read(os.path.join(GOLDEN_DIR, f"{name}.vapor"))


def check_goldens(backend: str = "torch", device: str = "cuda",
                  names: Optional[Iterable[str]] = None,
                  log: Optional[Callable[[str], None]] = None) -> dict:
    """Runs each golden (every one by default) in a fresh directory on
    `backend` and `device` and compares its output with the golden byte
    for byte.  Returns {name: {"ok", "s", "launches", "plain_on_cuda"}}:
    seconds from the build of the case to the output, the kernel
    launches of the run (counts set to 0 just before it, read just
    after; CUDA runs sync before the read), and the calls that plain
    versions got with CUDA tensors in it (none on the main path).  The
    CLI's own prints go to os.devnull."""
    import torch
    from ..engine import kernels
    results = {}
    for name in sorted(names or BUILDERS):
        want = golden_text(name)
        kernels.reset_counts()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix=f"golden_{name}_") as d, \
                open(os.devnull, "w") as devnull, \
                contextlib.redirect_stdout(devnull):
            got = run_golden(name, d, backend, device)
            if device.startswith("cuda"):
                torch.cuda.synchronize()
        results[name] = {"ok": got == want,
                         "s": time.perf_counter() - t0,
                         "launches": dict(kernels.LAUNCHES),
                         "plain_on_cuda": sum(
                             kernels.PLAIN_CUDA_CALLS.values())}
        if log:
            log(f"  {name} [{backend}, {device}]: "
                f"{'pass' if got == want else 'FAIL'} "
                f"({results[name]['s']:.2f} s) launches "
                f"{results[name]['launches']}")
    return results
