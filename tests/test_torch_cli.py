"""`python -m vapor_tpu_torch {bed,vcf,ins,svelter} --device cpu`
reproduces every golden of fixtures/golden/ byte for byte, on the cases
that tests/golden_cases.py builds, through the default (batched) backend
and through torch-nobatch; `pdf` equals vapor_tpu's own pdf mode."""
import os
import shutil
import sys

import pytest

import golden_cases as gc
import vapor_tpu_torch.cli as tcli
from vapor_tpu_torch.cli import main

BED_CASES = {f"bed_{t.lower()}_{seed}": (t, s0, e0, seed, het)
             for t, s0, e0, seed, het in gc.BED_CASES}


def _args(mode, sv_input, case, d, *extra):
    return [mode, "--sv-input", sv_input, "--reference", case["fasta"],
            "--pacbio-input", case["bam"], "--output-path",
            os.path.join(d, "figs"), *extra]


def _run(args):
    assert main([*args, "--device", "cpu", "--no-figures"]) == 0


def _bed(name, d):
    case = gc.build_big_case(d) if name == "bed_junction_big" else \
        gc.build_bed_case(d, *BED_CASES[name])
    out = os.path.join(d, "ours.vapor")
    _run(_args("bed", case["bed"], case, d, "--output-file", out))
    return out


def _vcf(build, annotated, d, monkeypatch):
    case = build(d)
    vcf = shutil.copyfile(case["vcf"], os.path.join(
        d, "ann_svs.vcf" if annotated else "my_svs.vcf"))
    if not annotated:   # the TSV alone, as golden_cases.run_vcf_case
        monkeypatch.setattr(tcli, "annotate_vcf", lambda *a, **k: None)
    _run(_args("vcf", vcf, case, d))
    return vcf + ".vapor"


def _svelter(d):
    case = gc.build_svelter_case(d)
    out = os.path.join(d, "ours.out")
    _run(_args("svelter", case["svelter"], case, d, "--output-file", out))
    return out


def _ins(d):
    case = gc.build_melt_case(d)
    _run(_args("ins", case["prefix"], case, d))
    return case["prefix"] + ".vapor"


GOLDENS = {
    "vcf_all_types": lambda d, mp: _vcf(gc.build_vcf_case, False, d, mp),
    "vcf_all_types_annotated":
        lambda d, mp: _vcf(gc.build_vcf_case, True, d, mp),
    "vcf_fallbacks": lambda d, mp: _vcf(gc.build_fb_case, False, d, mp),
    "svelter_basic": lambda d, mp: _svelter(d),
    "ins_melt": lambda d, mp: _ins(d),
}
BED_GOLDENS = sorted([*BED_CASES, "bed_junction_big"])


def _same_as_golden(out, name):
    with open(out) as got, \
            open(os.path.join(gc.GOLDEN_DIR, f"{name}.vapor")) as want:
        assert got.read() == want.read()


def test_every_golden_has_a_case():
    on_disk = {f[:-len(".vapor")] for f in os.listdir(gc.GOLDEN_DIR)
               if f.endswith(".vapor")}
    assert on_disk == set(GOLDENS) | set(BED_GOLDENS)


@pytest.mark.parametrize("name", BED_GOLDENS)
def test_bed_golden_on_cpu(name, tmp_path):
    _same_as_golden(_bed(name, str(tmp_path)), name)


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_golden_on_cpu(name, tmp_path, monkeypatch):
    _same_as_golden(GOLDENS[name](str(tmp_path), monkeypatch), name)


@pytest.mark.parametrize("name", [*BED_GOLDENS, *sorted(GOLDENS)])
def test_golden_on_cpu_unbatched(name, tmp_path, monkeypatch):
    """--backend torch-nobatch (a launch per request, each refiner step
    on its own) gives the goldens' bytes, as the batched default does."""
    monkeypatch.setattr(sys.modules[__name__], "main", lambda argv: tcli.main(
        [*argv, "--backend", "torch-nobatch"]))
    d = str(tmp_path)
    out = _bed(name, d) if name in BED_CASES or name == "bed_junction_big" \
        else GOLDENS[name](d, monkeypatch)
    _same_as_golden(out, name)


def test_device_refiner_equals_host_refiner_on_dup(tmp_path):
    """A tandem DUP through the CLI (vapor_tpu.sim.synth's case of
    test_refiner_integration_with_backend): the device refiner, through
    the batching backend, gives the bytes of the numpy backend's host
    refiner."""
    from vapor_tpu.sim.synth import build_test_case
    from vapor_tpu_torch.engine.window_device import BAND_STATS
    case = build_test_case(str(tmp_path), genome_len=16000,
                           sv=("DUP", 7000, 7400), read_len=2400,
                           n_donor=6, n_ref=6, seed=33)
    bed = tmp_path / "svs.bed"
    bed.write_text("chrS\t7000\t7400\tSV1\tDUP\n")
    outs = {}
    for be in ("numpy", "torch"):
        rounds = BAND_STATS["stat_rounds"]
        out = str(tmp_path / f"o_{be}.vapor")
        _run(_args("bed", str(bed), case, str(tmp_path), "--output-file",
                   out, "--backend", be))
        assert (BAND_STATS["stat_rounds"] > rounds) == (be == "torch")
        with open(out) as fh:
            outs[be] = fh.read()
    assert outs["numpy"] == outs["torch"]
    assert outs["torch"].count("\n") == 2


def test_bed_dup_golden_on_numpy_backend(tmp_path):
    """The tandem-DUP golden through the port's CLI on the numpy oracle:
    the same bytes as through the fused engine."""
    d = str(tmp_path)
    case = gc.build_bed_case(d, *BED_CASES["bed_dup_14"])
    out = os.path.join(d, "numpy.vapor")
    _run(_args("bed", case["bed"], case, d, "--output-file", out,
               "--backend", "numpy"))
    _same_as_golden(out, "bed_dup_14")


def test_pdf_matches_vapor_tpu(tmp_path):
    """pdf mode (4-column BED, --sv-type and --size-cff filters, output
    next to the input) against vapor_tpu's pdf mode on the numpy
    backend."""
    from vapor_tpu.cli import main as jax_main
    d = str(tmp_path)
    case = gc.build_bed_case(d, *BED_CASES["bed_dup_14"])
    bed4 = os.path.join(d, "calls.bed")
    with open(bed4, "w") as fo:
        fo.write("chrS\t6000\t6250\tDUP\nchrS\t6000\t6030\tDUP\n"
                 "chrS\t3000\t3400\tDEL\n")
    outs = []
    for name, run, extra in (("ours", main, ["--device", "cpu"]),
                             ("theirs", jax_main, ["--backend", "numpy"])):
        out = os.path.join(d, f"{name}.vapor")
        assert run(_args("pdf", bed4, case, d, "--output-file", out,
                         "--sv-type", "TANDUP", "--size-cff", "50",
                         "--PB-supp", "3", "--no-figures", *extra)) == 0
        with open(out) as fh:
            outs.append(fh.read())
    assert outs[0] == outs[1]
    assert outs[0].count("\n") == 2       # header + the one DUP >= 50 bp


def test_unported_modes_and_missing_card_exit_2(tmp_path, capsys):
    import torch
    d = str(tmp_path)
    case = gc.build_bed_case(d, "DEL", 6000, 6300, 11, True)
    out = os.path.join(d, "x.vapor")
    base = _args("bed", case["bed"], case, d, "--output-file", out)
    if not torch.cuda.is_available():
        # cuda is the default device: no card means no run, never the CPU
        for mode in ("bed", "vcf", "svelter", "scatter"):
            assert main([mode, *base[1:], "--no-figures"]) == 2
            assert "CUDA" in capsys.readouterr().err
        assert not os.path.exists(out)
