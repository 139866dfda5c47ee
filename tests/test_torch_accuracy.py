"""The ten-class truth corpus through vapor_tpu_torch's vcf subcommand on
the CPU against vapor_tpu's: one contig of 400 kb (seed 977, het, all
ten classes and false calls), built by both packages' builders into the
same bytes, gives the same annotated-VCF bytes through the port's
default backend (batching, device window refiner; torch on the CPU) as
through vapor_tpu's numpy oracle, and the port's evaluate holds the
per-class floors of tests/test_accuracy_corpus.py."""
import os

import pytest
import torch

import vapor_tpu.cli as jcli
import vapor_tpu_torch.cli as cli
from vapor_tpu_torch.sim.corpus import (GS_CFF, build_corpus, evaluate,
                                        parse_annotated)
from scripts_path import add_scripts_path

add_scripts_path()

import accuracy_corpus  # noqa: E402

torch.set_num_threads(1)      # the suite runs several processes at once


def _vcf_args(fa, bam, vcf, figs):
    return ["vcf", "--sv-input", vcf, "--reference", fa, "--pacbio-input",
            bam, "--output-path", figs, "--no-figures",
            "--validate-vcf-tandup"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(port's annotated VCF, vapor_tpu's, truth), each package's CLI on
    its own builder's corpus."""
    out = {}
    for name, build, main, backend in (
            ("jax", accuracy_corpus.build_corpus, jcli.main,
             ["--backend", "numpy"]),
            ("torch", build_corpus, cli.main,
             ["--backend", "torch", "--device", "cpu"])):
        d = str(tmp_path_factory.mktemp(name))
        fa, bam, vcf, truth = build(d, "het", n_contigs=1,
                                    contig_len=400000, seed=977)
        assert main(_vcf_args(fa, bam, vcf, os.path.join(d, "figs")) +
                    backend) == 0
        out[name] = (vcf + ".vapor", truth)
    assert out["torch"][1] == out["jax"][1]
    return out["torch"][0], out["jax"][0], out["torch"][1]


def test_annotated_vcf_equals_vapor_tpu(runs):
    got, want, truth = runs
    with open(got, "rb") as a, open(want, "rb") as b:
        got_bytes, want_bytes = a.read(), b.read()
    assert got_bytes == want_bytes
    n_records = sum(1 for x in got_bytes.splitlines()
                    if not x.startswith(b"#"))
    assert n_records == len(truth) >= 40


def test_corpus_floors(runs):
    """tests/test_accuracy_corpus.py's floors on the port's results."""
    got, _, truth = runs
    n_true = sum(1 for v in truth.values() if not v.startswith("FALSE"))
    assert n_true >= 30, n_true
    summary = evaluate(parse_annotated(got), truth)
    assert len(summary) >= 10
    for klass, stats in summary.items():
        if klass.startswith("FALSE"):
            assert stats["false_validation_rate"] <= 0.34, (klass, stats)
        elif klass in ("dup_inv", "dup_inv_ins"):
            evaluated = len(stats["gs_values"])
            validated = sum(1 for g in stats["gs_values"] if g >= GS_CFF)
            assert evaluated == 0 or validated / evaluated >= 0.5, \
                (klass, stats)
        else:
            assert stats["sensitivity"] >= 0.6, (klass, stats)
