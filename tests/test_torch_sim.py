"""vapor_tpu_torch's simulators against vapor_tpu's: with the same seeds
the port's builders write the same FASTA, BAM, BAI, BED and VCF bytes
and return the same truth, and the port's own numpy worklists
(sim/worklists.py) keep their event counts."""
import dataclasses
import os
import random
import textwrap

import pytest

from vapor_tpu.sim import scale as jscale
from vapor_tpu.sim import synth as jsynth
from vapor_tpu.sim import truthset as jtruthset
from vapor_tpu_torch.sim import corpus, scale, synth, truthset, worklists
from scripts_path import add_scripts_path

add_scripts_path()

import accuracy_corpus  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bytes(path):
    with open(path, "rb") as fh:
        return fh.read()


def _same_files(a_dir, b_dir):
    """Every file under a_dir equals its namesake under b_dir, and both
    hold the same names."""
    names = sorted(os.listdir(a_dir))
    assert names == sorted(os.listdir(b_dir))
    assert names
    for name in names:
        assert _bytes(os.path.join(a_dir, name)) == \
            _bytes(os.path.join(b_dir, name)), name
    return names


def _dirs(tmp_path):
    a, b = tmp_path / "jax", tmp_path / "torch"
    a.mkdir()
    b.mkdir()
    return str(a), str(b)


@pytest.mark.parametrize("sv,het", [(("DEL", 14000, 14400), True),
                                    (("INV", 12000, 12700), True),
                                    (("DUP", 15000, 15300), False)])
def test_build_test_case_writes_the_same_bytes(tmp_path, sv, het):
    a, b = _dirs(tmp_path)
    want = jsynth.build_test_case(a, sv=sv, het=het, seed=5)
    got = synth.build_test_case(b, sv=sv, het=het, seed=5)
    assert {"ref.fa", "reads.bam"} <= set(_same_files(a, b))
    assert {k: v for k, v in got.items() if k not in ("fasta", "bam")} == \
        {k: v for k, v in want.items() if k not in ("fasta", "bam")}


def test_mutate_and_simulate_reads_draw_the_same_stream():
    ref = synth.random_genome(5000, seed=3)["chrS"]
    assert ref == jsynth.random_genome(5000, seed=3)["chrS"]
    for svtype in ("DEL", "INV", "DUP", "INS"):
        assert synth.apply_sv(ref, svtype, 2000, 2300, "ACGT" * 20) == \
            jsynth.apply_sv(ref, svtype, 2000, 2300, "ACGT" * 20)
    hap = synth.apply_sv(ref, "INV", 2000, 2300)
    for from_donor in (True, False):
        got = synth.simulate_reads(ref, hap, 6, 1500, random.Random(4),
                                   region=(0, 1800), from_donor=from_donor)
        want = jsynth.simulate_reads(ref, hap, 6, 1500, random.Random(4),
                                     region=(0, 1800),
                                     from_donor=from_donor)
        assert got == want


def test_place_and_apply_svs_match(tmp_path):
    """The default spec distributed over two contigs, placed, applied with
    micro-indels and written as truth BED and VCF."""
    lengths = {"chr1": 150000, "chr2": 90000}
    out = {}
    for name, mod in (("jax", jtruthset), ("torch", truthset)):
        rng = random.Random(31)
        genome = {c: "".join(rng.choice("ACGT") for _ in range(n))
                  for c, n in lengths.items()}
        spec = mod.distribute_counts(mod.DEFAULT_SPEC, lengths, rng)
        placed, donors = [], {}
        for c, specs in spec.items():
            svs = mod.place_svs(lengths[c], c, specs, rng, buffer=3000)
            donors[c] = mod.apply_svs(genome[c], svs, rng)
            placed += svs
        bed = str(tmp_path / f"{name}.bed")
        vcf = str(tmp_path / f"{name}.vcf")
        mod.write_truth_bed(bed, placed)
        mod.write_truth_vcf(vcf, placed, lengths)
        out[name] = ([dataclasses.asdict(sv) for sv in placed], donors,
                     _bytes(bed), _bytes(vcf))
    assert len(out["torch"][0]) > 10
    assert out["torch"] == out["jax"]


@pytest.mark.parametrize("zygosity", ["het", "homo"])
def test_build_corpus_writes_the_same_bytes(tmp_path, zygosity):
    a, b = _dirs(tmp_path)
    want = accuracy_corpus.build_corpus(a, zygosity, 1, 150000, seed=977)
    got = corpus.build_corpus(b, zygosity, 1, 150000, seed=977)
    _same_files(a, b)
    assert got[3] == want[3]
    assert len(set(got[3].values())) >= 6


def test_corpus_scoring_helpers_are_the_scripts():
    assert corpus.GS_CFF == accuracy_corpus.GS_CFF
    rng_a, rng_b = random.Random(8), random.Random(8)
    template = "".join(random.Random(2).choice("ACGT") for _ in range(3000))
    assert corpus._noisy(template, rng_a) == \
        accuracy_corpus._noisy(template, rng_b)
    truth = {"sv0": "del", "sv1": "del", "fp0": "FALSE_DEL", "sv2": "inv"}
    results = {"sv0": {"gs": 0.5}, "sv1": {"gs": 0.1}, "fp0": {"gs": 0.4},
               "sv2": {"gs": None}}
    assert corpus.evaluate(results, truth) == \
        accuracy_corpus.evaluate(results, truth)


def test_repeat_cases_are_the_band_census_haps():
    """The 108 haps of the refiner-band census, as the JAX package's
    scripts/measure_refiner_band.py draws them: its own generator lines
    (from random.Random(99) to the case loop's end, less the refiner)
    run here."""
    path = os.path.join(REPO, "scripts", "measure_refiner_band.py")
    with open(path) as fh:
        src = fh.read()
    block = src[src.index("    rng = random.Random(99)"):
                src.index("    results = {}")]
    block = "\n".join(line for line in block.splitlines()
                      if "DeviceWindowRefiner" not in line)
    ns = {"random": random}
    exec(textwrap.dedent(block), ns)
    cases = corpus.repeat_cases()
    assert len(cases) == 108
    assert cases == ns["cases"]


def test_build_scale_case_writes_the_same_bytes(tmp_path):
    a, b = _dirs(tmp_path)
    want = jscale.build_scale_case(a, n_contigs=2, contig_len=40000,
                                   events_per=3, reads_per=6, seed=77)
    got = scale.build_scale_case(b, n_contigs=2, contig_len=40000,
                                 events_per=3, reads_per=6, seed=77)
    assert _same_files(a, b) == ["calls.bed", "reads.bam", "reads.bam.bai",
                                 "ref.fa", "ref.fa.fai"]
    for key in ("truth", "n_events", "n_reads"):
        assert got[key] == want[key]
    assert got["n_events"] == 10
    assert scale.READ_LEN == jscale.READ_LEN


def test_jax_signature_build_event_worklist_writes_the_same_bytes(tmp_path):
    """scale.build_event_worklist(tmpdir, n_events) is vapor_tpu's: 7
    means 7 events (the port's 34-event worklist is
    worklists.build_event_worklist)."""
    a, b = _dirs(tmp_path)
    want = jscale.build_event_worklist(a, 7, spans=(400, 900))
    got = scale.build_event_worklist(b, 7, spans=(400, 900))
    _same_files(a, b)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    with open(got[2]) as fh:
        assert len(fh.readlines()) == 7


@pytest.mark.parametrize("n_contigs", [1, 4])
def test_worklists_keep_their_events(tmp_path, n_contigs):
    """The port's own numpy worklists: the bed worklist holds 34 events on
    n_contigs contigs, the vcf worklist 24."""
    fa, bam, bed, events = worklists.build_event_worklist(
        str(tmp_path), 7, n_contigs=n_contigs)
    assert len(events) == 34
    with open(bed) as fh:
        rows = fh.readlines()
    assert len(rows) == 34
    assert len({r.split("\t")[0] for r in rows}) == n_contigs
    vdir = tmp_path / "vcf"
    vdir.mkdir()
    _, _, vcf, vevents = worklists.build_vcf_worklist(str(vdir), 7)
    assert len(vevents) == 24
    with open(vcf) as fh:
        assert sum(1 for x in fh if not x.startswith("#")) == 24
