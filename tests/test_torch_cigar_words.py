"""The port's CIGAR words (vapor_tpu_torch/io/cigar.py) against the text
CIGAR of vapor_tpu: the walk to a window's start, the reference length,
the clip's three gates, and reads gathered through a .bai on long reads
at 8% errors, record by record and read by read."""
import random

import numpy as np
import pytest

from vapor_tpu.io import bam as jbam
from vapor_tpu.io import cigar as jcigar
from vapor_tpu.io import reads as jreads
from vapor_tpu.io.bai import IndexedBam as JaxIndexedBam
from vapor_tpu_torch.io import bam as tbam
from vapor_tpu_torch.io import cigar as tcigar
from vapor_tpu_torch.io import reads as treads
from vapor_tpu_torch.io.bai import IndexedBam, write_bai

OPS = "MIDNSHP=X"
READ_OPS = set("MIS=X")          # the ops a read's bases count


def _random_cigar(rng: random.Random) -> str:
    n = rng.choice([1, 1, 2, 3, rng.randint(4, 40)])
    return "".join(f"{rng.randint(0 if rng.random() < 0.02 else 1, 60)}"
                   f"{rng.choice(OPS)}" for _ in range(n))


def _walk_case(rng: random.Random):
    """(cigar, pos1, start1): start1 at, before and after POS, and past
    the alignment's end, where the walk runs out."""
    cigar = _random_cigar(rng)
    pos1 = rng.randint(1, 5000)
    span = sum(int(n) for n, op in jcigar._CIGAR_RE.findall(cigar)
               if op in "MD=")
    start1 = pos1 + rng.choice([0, -1, 1, rng.randint(-50, span + 50),
                                span, span + 1, span + rng.randint(2, 99)])
    return cigar, pos1, start1


CRAFTED = [
    ("*", 100, 100), ("*", 100, 250), ("*", 100, 40),
    ("50M", 1000, 1000), ("50M", 1000, 999), ("50M", 1000, 2000),
    ("10S", 1000, 1000), ("10S", 1000, 1100),
    ("10S100M", 1000, 1050), ("50M5D50M", 1000, 1052),
    ("50M5I50M", 1000, 1060), ("50M100S", 1000, 2000),
    ("20M30X40M", 100, 130), ("20M30N40M", 100, 130),
    ("20M3H40M", 100, 121), ("20M3P40M", 100, 121),
    ("20M5D10X", 100, 122), ("20=5I20=", 100, 110),
    ("5X", 10, 10), ("5N", 10, 12), ("5H", 10, 8), ("5P", 10, 11),
    ("0M10D", 10, 15), ("3I", 1, 1),
]


def _assert_walk(cigar, pos1, start1):
    words = tcigar.encode_cigar(cigar)
    assert words.dtype == np.dtype("<u4")
    assert words.tobytes() == (b"" if cigar == "*" else
                               jbam._encode_cigar(cigar))
    assert tcigar.render_cigar(words) == cigar
    assert tcigar.cigar_align_start(words, pos1, start1) == \
        jcigar.cigar_align_start(cigar, pos1, start1), (cigar, pos1, start1)
    text = jbam.BamRecord("r", 0, 0, pos1 - 1, 60, cigar, "", b"")
    assert tcigar.ref_length(words) == text.ref_length


@pytest.mark.parametrize("cigar,pos1,start1", CRAFTED)
def test_walk_matches_the_text_walk_crafted(cigar, pos1, start1):
    _assert_walk(cigar, pos1, start1)


@pytest.mark.parametrize("seed", range(6))
def test_walk_matches_the_text_walk_random(seed):
    rng = random.Random(seed)
    runs_out = 0
    for _ in range(500):
        case = _walk_case(rng)
        _assert_walk(*case)
        runs_out += tcigar.cigar_align_start(
            tcigar.encode_cigar(case[0]), case[1], case[2])[1] < 0
    assert runs_out > 0


def _clip_pair(cigar, seq, pos1, start1, end1, flank):
    """The port's clip of a record built from text, and vapor_tpu's
    text clip."""
    rec = tbam.BamRecord("r", 0, 0, pos1 - 1, 60, cigar, seq, b"")
    want = jcigar.clip_read_to_window(seq, cigar, pos1, start1, end1, flank)
    return tcigar.clip_read_to_window(rec, start1, end1, flank), want


def _seq_for(cigar, rng):
    n = sum(int(k) for k, op in jcigar._CIGAR_RE.findall(cigar)
            if op in READ_OPS)
    return "".join(rng.choice("ACGTN") for _ in range(n))


# (gate, cigar, pos1, start1, end1, flank): POS, miss_bp, then length
GATES = [
    ("pos", "300M", 501, 500, 700, 400),
    ("miss", "100M300D200M", 101, 300, 500, 400),
    ("kept_miss_at_half", "100M300D200M", 101, 301, 700, 400),
    ("length", "300M", 101, 200, 500, 400),
    ("kept", "2000M", 101, 500, 900, 400),
    ("kept_negative_miss", "100M50X", 101, 400, 200, 400),
    ("kept_want_negative", "50M40D100M", 101, 180, 150, 400),
    ("kept_at_pos", "10S300M", 201, 201, 400, 100),
]


@pytest.mark.parametrize("gate,cigar,pos1,start1,end1,flank", GATES,
                         ids=[g[0] for g in GATES])
def test_clip_gates(gate, cigar, pos1, start1, end1, flank):
    seq = _seq_for(cigar, random.Random(7))
    got, want = _clip_pair(cigar, seq, pos1, start1, end1, flank)
    assert got == want
    assert (want is None) == (not gate.startswith("kept")), want


@pytest.mark.parametrize("seed", range(4))
def test_clip_matches_the_text_clip_random(seed, tmp_path):
    """Records built from text and records read back from a BAM (whose
    bases are decoded a slice at a time) clip as the text does."""
    rng = random.Random(100 + seed)
    cases = []
    for i in range(300):
        cigar, pos1, start1 = _walk_case(rng)
        if cigar == "*":
            continue
        seq = _seq_for(cigar, rng)
        end1 = start1 + rng.randint(-20, 400)
        flank = rng.choice([0, 20, 100, 1000])
        cases.append((cigar, seq, pos1, start1, end1, flank))
    kept = 0
    for case in cases:
        got, want = _clip_pair(*case)
        assert got == want, case
        kept += want is not None
    assert kept > 0
    cases.sort(key=lambda c: c[2])
    records = [tbam.BamRecord(f"r{i}", 0, 0, pos1 - 1, 60, cigar, seq, b"")
               for i, (cigar, seq, pos1, *_) in enumerate(cases)]
    path = str(tmp_path / "c.bam")
    tbam.write_bam(path, [("c", 10 ** 6)], records)
    back = list(tbam.BamReader(path, native=False))
    assert len(back) == len(cases)
    for rec, (cigar, seq, pos1, start1, end1, flank) in zip(back, cases):
        assert (rec.cigar, rec.seq) == (cigar, seq)
        assert tcigar.clip_read_to_window(rec, start1, end1, flank) == \
            jcigar.clip_read_to_window(seq, cigar, pos1, start1, end1,
                                       flank)


def _long_read(rng: np.random.Generator, genome_len: int):
    """(pos0, cigar, seq) of a 1-40 kb read at 8% errors (substitutions,
    insertions and deletions alike) with soft clips and =/X runs."""
    length = int(np.clip(rng.lognormal(np.log(10000), 0.5), 1000, 40000))
    pos0 = int(rng.integers(0, genome_len - 1000))
    parts, n_read, n_ref = [], 0, 0
    if rng.random() < 0.5:
        k = int(rng.integers(1, 300))
        parts.append(f"{k}S")
        n_read += k
    match = "M" if rng.random() < 0.8 else "="
    while n_read < length and pos0 + n_ref < genome_len - 50:
        k = int(rng.geometric(0.08))
        parts.append(f"{k}{match}")
        n_read += k
        n_ref += k
        err = rng.choice(["X", "I", "D"])
        k = int(rng.integers(1, 4))
        if err == "X" and match == "M":
            err = "M"
        parts.append(f"{k}{err}")
        n_read += k * (err != "D")
        n_ref += k * (err != "I")
    if rng.random() < 0.5:
        k = int(rng.integers(1, 300))
        parts.append(f"{k}S")
        n_read += k
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n_read)]
    return pos0, "".join(parts), seq.tobytes().decode()


@pytest.fixture(scope="module")
def long_read_bam(tmp_path_factory):
    rng = np.random.default_rng(19)
    refs = [("c1", 150000), ("c2", 60000)]
    records = []
    for rid, (_, n) in enumerate(refs):
        reads = sorted(_long_read(rng, n) for _ in range(n * 12 // 10000))
        records += [tbam.BamRecord(f"m{rid}/{i}/ccs", 16 * (i % 2), rid,
                                   p, 60, c, s, b"")
                    for i, (p, c, s) in enumerate(reads)]
    path = str(tmp_path_factory.mktemp("long") / "reads.bam")
    tbam.write_bam(path, refs, records)
    write_bai(path)
    return path


def _windows():
    rng = random.Random(5)
    out = [("c1", 1, 3000), ("c1", 16384, 16385), ("c1", 140000, 150000),
           ("c1", 149000, 160000), ("c2", 1, 60000), ("c2", 30000, 30010),
           ("c3", 1, 100)]
    for _ in range(24):
        s = rng.randint(1, 148000)
        out.append(("c1", s, s + rng.choice([200, 1500, 8000, 20000])))
    return out


def test_indexed_records_equal_the_text_records(long_read_bam):
    ours, theirs = IndexedBam(long_read_bam), JaxIndexedBam(long_read_bam)
    ops = 0
    for chrom, s, e in _windows():
        got = [(r.name, r.flag, r.ref_id, r.pos0, r.mapq, r.cigar, r.seq,
                r.qual, r.end_pos0) for r in ours.fetch(chrom, s, e)]
        want = [(r.name, r.flag, r.ref_id, r.pos0, r.mapq, r.cigar, r.seq,
                 r.qual, r.end_pos0) for r in theirs.fetch(chrom, s, e)]
        assert got == want, (chrom, s, e)
        ops += sum(len(jcigar._CIGAR_RE.findall(g[5])) for g in got)
    assert ops > 10000


@pytest.mark.parametrize("flank", [100, 1000, 4000])
def test_indexed_reads_equal_the_text_reads(long_read_bam, flank):
    treads._open_bam.cache_clear()
    jreads._open_bam.cache_clear()
    assert isinstance(treads._open_bam(long_read_bam), IndexedBam)
    kept = 0
    for chrom, s, e in _windows():
        got = treads.extract_spanning_reads(long_read_bam, chrom, s, e,
                                            flank)
        want = jreads.extract_spanning_reads(long_read_bam, chrom, s, e,
                                             flank)
        assert got == want, (chrom, s, e)
        assert treads.subsample_reads(got) == jreads.subsample_reads(want)
        kept += len(got)
    assert kept > 20
