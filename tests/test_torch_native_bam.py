"""The port's native BAM codec (vapor_tpu_torch/native, built with g++
at first use) against the pure-Python decoders of both packages, on
tests/test_native_bam.py's file, and its build when several processes
start it at once."""
import os
import random
import subprocess
import sys

import pytest

from vapor_tpu.io.bam import BamReader as JaxBamReader
from vapor_tpu.io.bam import BamRecord, _decompress_bgzf, write_bam
from vapor_tpu_torch import native
from vapor_tpu_torch.io import bam as tbam

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def bam_file(tmp_path_factory):
    rng = random.Random(17)
    d = tmp_path_factory.mktemp("nbam")
    refs = [("c1", 50000), ("c2", 30000)]
    records = []
    for rid in (0, 1):
        pos = 50
        for i in range(80):
            ln = rng.randint(60, 400)
            cigar = f"{ln // 2}M5I3D{ln - ln // 2}M" if i % 3 else f"{ln}M"
            seq_len = ln // 2 + 5 + (ln - ln // 2) if i % 3 else ln
            seq = "".join(rng.choice("ACGTN") for _ in range(seq_len))
            records.append(BamRecord(
                name=f"r{rid}_{i}", flag=i % 4 * 16, ref_id=rid, pos0=pos,
                mapq=rng.randint(0, 60), cigar=cigar, seq=seq, qual=b""))
            pos += rng.randint(5, 700)
    path = str(d / "t.bam")
    write_bam(path, refs, records)
    return path


def _fields(records):
    return [(r.name, r.flag, r.pos0, r.mapq, r.cigar, r.seq)
            for r in records]


def test_native_available():
    assert native.load() is not None, native.LOAD_ERROR
    path = native.library_path()
    assert os.path.dirname(path) == os.path.join(
        ROOT, "vapor_tpu_torch", "native", "_build")
    assert os.path.exists(path)


def test_bgzf_decompress_matches(bam_file):
    with open(bam_file, "rb") as fh:
        raw = fh.read()
    want = _decompress_bgzf(bam_file)
    assert native.bgzf_decompress(raw) == want
    assert tbam._decompress_bgzf(bam_file) == want


def test_fetch_matches_python(bam_file):
    nat = tbam.BamReader(bam_file)
    pyr = tbam.BamReader(bam_file, native=False)
    ref = JaxBamReader(bam_file, native=False)
    assert (nat.decoder, pyr.decoder) == ("native", "python")
    assert nat.references == ref.references == ["c1", "c2"]
    rng = random.Random(3)
    regions = [("c1", 1, 50000), ("c2", 1, 30000), ("c1", 100, 101),
               ("missing", 1, 10)]
    regions += [("c1", a + 1, a + rng.randint(1, 5000))
                for a in (rng.randint(0, 45000) for _ in range(10))]
    for chrom, s, e in regions:
        want = _fields(ref.fetch(chrom, s, e))
        assert _fields(nat.fetch(chrom, s, e)) == want, (chrom, s, e)
        assert _fields(pyr.fetch(chrom, s, e)) == want, (chrom, s, e)
    assert any(_fields(ref.fetch("c1", 1, 50000)))


def test_processes_building_at_once_both_load(tmp_path):
    """Two processes that find the build directory empty compile at
    once; each writes its own temporary file and moves it into place,
    so both load a whole library and one library is left."""
    build = str(tmp_path / "build")
    code = ("import sys; from vapor_tpu_torch import native; "
            "native.BUILD_DIR = sys.argv[1]; lib = native.load(); "
            "assert lib is not None, native.LOAD_ERROR; "
            "print(native.library_path())")
    procs = [subprocess.Popen([sys.executable, "-c", code, build], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=180) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [o[1] for o in outs]
    paths = {o[0].strip() for o in outs}
    assert len(paths) == 1 and os.path.dirname(paths.pop()) == build
    assert [f for f in os.listdir(build) if f.endswith(".so")] == \
        os.listdir(build)
    assert len(os.listdir(build)) == 1
