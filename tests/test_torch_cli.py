"""`python -m vapor_tpu_torch bed --device cpu` reproduces the DEL/INV
bed goldens of fixtures/golden/ byte for byte, on the cases that
tests/golden_cases.py builds."""
import os

import pytest

import golden_cases as gc
from vapor_tpu_torch.cli import main

CASES = {
    "bed_del_11": lambda d: gc.build_bed_case(d, "DEL", 6000, 6300, 11,
                                              True),
    "bed_del_12": lambda d: gc.build_bed_case(d, "DEL", 6000, 6200, 12,
                                              False),
    "bed_inv_13": lambda d: gc.build_bed_case(d, "INV", 6000, 6350, 13,
                                              True),
    "bed_junction_big": gc.build_big_case,
}


def _args(case, out, d, *extra):
    return ["bed", "--sv-input", case["bed"], "--reference", case["fasta"],
            "--pacbio-input", case["bam"], "--output-path",
            os.path.join(d, "figs"), "--output-file", out, *extra]


@pytest.mark.parametrize("name", sorted(CASES))
def test_bed_golden_on_cpu(name, tmp_path):
    d = str(tmp_path)
    case = CASES[name](d)
    out = os.path.join(d, "ours.vapor")
    assert main(_args(case, out, d, "--device", "cpu", "--no-figures")) == 0
    with open(out) as got, \
            open(os.path.join(gc.GOLDEN_DIR, f"{name}.vapor")) as want:
        assert got.read() == want.read()


def test_unported_modes_and_missing_card_exit_2(tmp_path, capsys):
    import torch
    d = str(tmp_path)
    case = gc.build_bed_case(d, "DEL", 6000, 6300, 11, True)
    out = os.path.join(d, "x.vapor")
    for mode in ("vcf", "ins", "svelter", "pdf", "scatter"):
        args = _args(case, out, d, "--device", "cpu")
        args[0] = mode
        assert main(args) == 2
        assert "not ported yet" in capsys.readouterr().err
    assert main(_args(case, out, d, "--trace")) == 2
    if not torch.cuda.is_available():
        # cuda is the default device: no card means no run, never the CPU
        assert main(_args(case, out, d, "--no-figures")) == 2
        assert "CUDA" in capsys.readouterr().err
        assert not os.path.exists(out)
