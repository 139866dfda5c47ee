"""The frozen generator: the program's readers parse what it writes, and
the same seed writes the same bytes."""
import hashlib
import json
import os

import numpy as np

from benchmarks import gen, harness
from benchmarks.gen.layout import ASCII

from .conftest import BED, make_tiny


def _tiny_cell(tmp_path, name, events=4):
    spec = make_tiny(str(tmp_path / "root"), events)
    return harness.load_cell(name, spec, os.path.join(
        os.path.dirname(spec), "benchmarks"))


def _digest(root):
    out = {}
    for name in sorted(os.listdir(root)):
        with open(os.path.join(root, name), "rb") as fh:
            out[name] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_same_seed_same_bytes(tmp_path):
    cell = _tiny_cell(tmp_path, "hg002_tier1.clr30x")
    a = gen.build(str(tmp_path / "a"), cell.config, cell.traffic, 2**31 + 5)
    b = gen.build(str(tmp_path / "b"), cell.config, cell.traffic, 2**31 + 5)
    c = gen.build(str(tmp_path / "c"), cell.config, cell.traffic, 2**31 + 6)
    assert _digest(a.root) == _digest(b.root)
    assert _digest(a.root)["reads.bam"] != _digest(c.root)["reads.bam"]


def test_program_reads_the_files(tmp_path):
    from vapor_tpu_torch.io.bai import IndexedBam
    from vapor_tpu_torch.io.bam import BamReader
    from vapor_tpu_torch.io.fasta import FastaFile
    from vapor_tpu_torch.io.parsers import bed_info_readin, vcf_list_readin
    for name in ("hg002_tier1.clr30x", BED):
        cell = _tiny_cell(tmp_path / name, name)
        inp = gen.build(str(tmp_path / name / "d"), cell.config,
                        cell.traffic, 11)
        indexed = IndexedBam(inp.bam)
        whole = BamReader(inp.bam, native=False)
        fasta = FastaFile(inp.fasta)
        for contig, events in inp.events.items():
            g = inp.genome(contig)
            assert fasta.fetch(contig, 1, len(g)) == \
                ASCII[g].tobytes().decode()
            for ev in events:
                rd = inp.reads(ev, g)
                want = [(rd.names[i], int(rd.pos[i]), rd.cigar_text(i),
                         rd.seq_text(i), int(rd.end[i]))
                        for i in range(len(rd.pos))
                        if rd.pos[i] < ev.we and rd.end[i] > ev.ws - 1]
                for reader in (indexed, whole):
                    got = [(r.name, r.pos0, r.cigar, r.seq, r.end_pos0)
                           for r in reader.fetch(contig, ev.ws, ev.we)]
                    assert got == want
        if inp.mode == "vcf":
            worklist, _ = vcf_list_readin(inp.calls)
            got = sorted((y[0], y[1]) for v in worklist.values() for y in v)
        else:
            got = sorted((x[0], x[1]) for x in bed_info_readin(inp.calls))
        assert got == sorted((ev.contig, ev.s) for evs in
                             inp.events.values() for ev in evs)


def test_no_read_reaches_another_window(tmp_path):
    cell = _tiny_cell(tmp_path, BED, events=6)
    inp = gen.build(str(tmp_path / "d"), cell.config, cell.traffic, 3)
    for contig, events in inp.events.items():
        g = inp.genome(contig)
        for ev in events:
            rd = inp.reads(ev, g)
            assert (rd.pos >= ev.lo).all() and (rd.end <= ev.hi).all()
            for other in events:
                if other is not ev:
                    assert not ((rd.pos < other.we) &
                                (rd.end > other.ws - 1)).any()


def test_layout_is_the_same_work_on_every_seed(tmp_path):
    cell = _tiny_cell(tmp_path, "hg002_tier1.clr30x", events=6)
    a = gen.build(str(tmp_path / "a"), cell.config, cell.traffic, 1)
    b = gen.build(str(tmp_path / "b"), cell.config, cell.traffic, 2)
    for contig in a.events:
        assert [(e.kind, e.size, e.s, e.ws, e.we) for e in a.events[contig]] \
            == [(e.kind, e.size, e.s, e.ws, e.we) for e in b.events[contig]]
    assert json.dumps(a.lengths) == json.dumps(b.lengths)
    ra = [len(a.reads(ev).pos) for ev in a.events["chr1"]]
    rb = [len(b.reads(ev).pos) for ev in b.events["chr1"]]
    assert ra == rb and np.sum(ra) > 0
