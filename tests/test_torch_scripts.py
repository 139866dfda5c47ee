"""The port's measurement scripts (scripts/*_torch.py) on the CPU: the
CLI parity check passes goldens, the pipeline-depth bench gives the same
bytes at every depth as vapor_tpu's numpy run, the scale run's tally
keeps the JAX script's qs > 0.2 rule, the scaling curve's balance equals
vapor_tpu's shard assignment, the engine profile's rows and stages match
the JAX profile's, the card placement run's scatter and 4 ranks give the
plain run's bytes, and no script runs without a card unless --device cpu
is given.  All comparisons are exact."""
import os

import pytest
import torch

from scripts_path import add_scripts_path

add_scripts_path()

import card_placement_torch  # noqa: E402
import cli_parity_torch  # noqa: E402
import e2e_pipeline_bench_torch  # noqa: E402
import profile_e2e_torch  # noqa: E402
import profile_engine_torch  # noqa: E402
import scale_run_torch  # noqa: E402
import scaling_curve_torch  # noqa: E402
import scaling_sim_torch  # noqa: E402
from vapor_tpu_torch.sim import goldens  # noqa: E402

SCRIPTS = {"card_placement_torch": card_placement_torch,
           "cli_parity_torch": cli_parity_torch,
           "e2e_pipeline_bench_torch": e2e_pipeline_bench_torch,
           "scale_run_torch": scale_run_torch,
           "scaling_sim_torch": scaling_sim_torch,
           "scaling_curve_torch": scaling_curve_torch,
           "profile_engine_torch": profile_engine_torch,
           "profile_e2e_torch": profile_e2e_torch}


@pytest.mark.parametrize("backend", ["torch", "torch-nobatch"])
def test_cli_parity_passes_svelter_and_ins(backend):
    names = ["ins_melt", "svelter_basic"]
    got = cli_parity_torch.run_backend(backend, "cpu", names)
    assert sorted(got) == names
    assert all(r["ok"] for r in got.values()), got
    assert all(r["plain_on_cuda"] == 0 for r in got.values())


def test_cli_parity_reports_a_differing_golden(monkeypatch):
    monkeypatch.setattr(goldens, "golden_text", lambda name: "#other\n")
    got = cli_parity_torch.run_backend("torch", "cpu", ["ins_melt"])
    assert got["ins_melt"]["ok"] is False


def test_pipeline_depths_equal_each_other_and_vapor_tpu(tmp_path):
    from vapor_tpu.cli import main as jax_main
    d = str(tmp_path)
    fa, bam, bed, n = e2e_pipeline_bench_torch.build_worklist(d, "events", 6)
    assert n == 6
    report = e2e_pipeline_bench_torch.bench(d, fa, bam, bed, n, "torch",
                                            "cpu", [4], log=lambda s: None)
    assert report["identical"] and set(report["points"]) == {"1", "4"}
    with open(os.path.join(d, "out_p1.vapor"), "rb") as fh:
        depth1 = fh.read()
    with open(os.path.join(d, "out_p4.vapor"), "rb") as fh:
        assert fh.read() == depth1
    ref = os.path.join(d, "numpy.vapor")
    assert jax_main(["bed", "--sv-input", bed, "--reference", fa,
                     "--pacbio-input", bam, "--output-path",
                     os.path.join(d, "figs_numpy"), "--output-file", ref,
                     "--backend", "numpy", "--no-figures"]) == 0
    with open(ref, "rb") as fh:
        assert fh.read() == depth1
    assert depth1.count(b"\n") == 7
    assert report["reads_scored"] == \
        e2e_pipeline_bench_torch.reads_scored(depth1.decode())


def test_scale_run_tally_keeps_the_qs_rule(tmp_path):
    """Rows of a hand-made bed output: a call is a quality score above
    0.2; NA and empty scores are not calls; NA records score no read."""
    header = "#CHR\tPOS\tEND\tSVTYPE\tSVID\tVaPoR_QS\tVaPoR_GS\t" \
        "VaPoR_GT\tVaPoR_GQ\tVaPoR_Rec\n"
    rows = [("T1", "0.9", "0.1,0.2,0.3"),    # true, called: TP
            ("T2", "0.2", "0.5,0.5"),        # true, 0.2 is no call: FN
            ("T3", "NA", "NA"),              # true, NA: FN
            ("F1", "0.21", "0.4"),           # false, called: FP
            ("F2", "", ""),                  # false, empty: TN
            ("F3", "0.05", "0.1,0.1,0.1,0.1"),  # false, low: TN
            ("X9", "0.7", "0.9")]            # not in the truth: FP
    path = tmp_path / "hand.vapor"
    path.write_text(header + "".join(
        f"chr1\t{100 * i}\t{100 * i + 50}\tDEL\t{sv}\t{qs}\tNA\tNA\tNA\t"
        f"{rec}\n" for i, (sv, qs, rec) in enumerate(rows)))
    truth = {"T1": True, "T2": True, "T3": True, "F1": False, "F2": False,
             "F3": False}
    assert scale_run_torch.tally(str(path), truth) == {
        "events": 7, "reads_evaluated": 3 + 2 + 1 + 4 + 1, "TP": 1,
        "FN": 2, "FP": 2, "TN": 2}


def test_scaling_curve_balance_equals_vapor_tpu(tmp_path):
    """The imbalanced worklist's greedy and round-robin largest shards
    and the ideal, from the port's shard_worklist, equal the JAX
    script's from vapor_tpu's, at 2, 4 and 8 hosts."""
    import scaling_curve
    from vapor_tpu_torch.sim.scale import build_scale_case
    case = build_scale_case(str(tmp_path), n_contigs=3, contig_len=60000,
                            events_per=12, reads_per=2, n_false_per=1,
                            seed=32)
    scaling_curve_torch.skew(case["bed"])
    events = scaling_curve_torch.events_of(case["bed"])
    assert len({e[0] for e in events}) == 3
    for n in (2, 4, 8):
        got = scaling_curve_torch.assignment_balance(events, n)
        assert got == scaling_curve._assignment_balance(events, n)
    greedy, rr, _ = scaling_curve_torch.assignment_balance(events, 2)
    assert greedy < rr


def test_profile_rows_equal_the_jax_profile():
    import numpy as np
    import profile_engine
    for got, want in zip(profile_engine_torch.make_rows(256, 192, 5),
                         profile_engine.make_rows(256, 192, 5)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_profile_engine_stages_on_cpu(monkeypatch):
    """Each scorer's full stage launches its mode's kernels, and the
    hist stage's bound is the roofline of hist's own work."""
    from vapor_tpu_torch.engine.kernels import roofline
    monkeypatch.setattr(profile_engine_torch, "B", 8)
    ent = profile_engine_torch.profile_bucket(256, torch.device("cpu"))
    stages = ent["stages"]
    assert {n: stages[f"full_{n}"]["kernels"]
            for n in profile_engine_torch.SCORERS} == {
        "m1b": ["hist", "moment"], "del": ["hist", "left_hist", "moment2"],
        "w10": ["hist", "left_hist", "moment"],
        "rdd": ["hist", "kept_hist", "rdd_moment"]}
    hist = stages["hist"]
    assert (hist["bound_ms"], hist["bound_by"]) == \
        roofline.bound(hist["bytes"], hist["operations"])
    assert ent["hits"] > 0 and "ms" not in hist
    for n in profile_engine_torch.SCORERS:
        full = stages[f"full_{n}"]
        assert full["operations"] > hist["operations"] + \
            stages["codes"]["operations"]


def test_card_placement_runs_equal_the_plain_run(tmp_path, monkeypatch):
    """Scatter --jobs 4 and 4 gloo ranks on the CPU, through the same
    PYTHONPATH hook that reports a process's cards on the card: the
    plain run's bytes; no process touches CUDA."""
    import json
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    out = str(tmp_path / "placement.json")
    assert card_placement_torch.main(["--device", "cpu", "--reps", "1",
                                      "--out", out]) == 0
    with open(out) as fh:
        report = json.load(fh)
    assert set(report) == {"tree", "device", "plain", "scatter0", "ranks0"}
    assert report["scatter0"]["equal"] and report["ranks0"]["equal"]
    assert not any(report[x]["processes"] for x in ("plain", "scatter0",
                                                     "ranks0"))


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_script_without_card_exits_nonzero(name, monkeypatch, capsys):
    """The card is every script's default: without one, and without
    --device cpu, a script exits non-zero before doing any work."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    monkeypatch.delenv("SCALE_DEVICE", raising=False)
    assert SCRIPTS[name].main([]) != 0
    assert "no CUDA card" in capsys.readouterr().err
