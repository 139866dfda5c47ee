"""The cell na12878_1kgp.clr30x: its configuration's layout, and a tiny
traced run judged against the reference, with its six readers reading
the rdd route, the junction windows, the host's scoring and the DUP
validator's spans, and reading nothing on a program without them."""
import json
import os

import pytest

from benchmarks import harness
from benchmarks.gen.layout import make_layout

from .conftest import REPO, make_tiny, run_tiny

CELL = "na12878_1kgp.clr30x"
PROGRAM_READERS = ("rdd_rows_per_event", "junction_share",
                   "host_scored_reads_per_event",
                   "validate_dup_ms_per_event")
DEVICE_READERS = ("rdd_kernel_ms_per_event", "rdd_kernels_roofline")
# the largest haplotype bucket of the program (engine/constants.py)
LARGEST_BUCKET = 16384


def _spec():
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _reader(name):
    return harness.load_reader(harness.BENCH, name)


def test_configuration_follows_the_release():
    """The release's DEL:DUP:INV shares and size bins, and a layout whose
    whole-event DUPs all fit the largest bucket: 155 whole-event and 17
    junction DEL, 22 and 3 DUP, 3 INV a contig."""
    spec = _spec()
    entry = next(c for c in spec["configs"] if c["name"] == "na12878_1kgp")
    with open(os.path.join(REPO, entry["file"])) as fh:
        cfg = json.load(fh)
    assert cfg["reduced"] == entry["reduced"]
    assert cfg["mode"] == "bed"
    assert sum(cfg["types"].values()) == pytest.approx(1.0)
    assert sum(b[2] for b in cfg["sizes"]) == pytest.approx(1.0)
    cell = next(w for w in spec["workloads"] if w["name"] == CELL)
    with open(os.path.join(harness.BENCH, "traffic",
                           cell["traffic"] + ".json")) as fh:
        traffic = json.load(fh)
    tally = {}
    for sh in make_layout(cfg, traffic):
        whole = sh.size - 1 < 10000
        key = (sh.kind, whole)
        tally[key] = tally.get(key, 0) + 1
        if sh.kind == "DUP" and whole:
            assert 2 * sh.size + 2 * min(sh.size - 1, 500) + 1 <= \
                LARGEST_BUCKET
    assert tally == {("DEL", True): 155, ("DEL", False): 17,
                     ("DUP", True): 22, ("DUP", False): 3,
                     ("INV", True): 3}


def test_new_metrics_list_the_cell_alone():
    spec = _spec()
    names = PROGRAM_READERS + DEVICE_READERS
    metrics = {m["name"]: m for m in spec["per_layer"]}
    for name in names:
        assert metrics[name]["workloads"] == [CELL]
        assert metrics[name]["moves"] == "peak_host_rss_mib"
        assert os.path.exists(os.path.join(harness.BENCH, "metrics",
                                           name + ".py"))


@pytest.fixture
def tiny16(tmp_path, monkeypatch):
    """The cell at 16 events a contig (the type split then holds DUPs)."""
    spec = make_tiny(str(tmp_path / "root"), events=16)
    monkeypatch.setenv("TMPDIR", str(tmp_path / "tmp"))
    return harness.load_cell(CELL, spec, os.path.join(
        os.path.dirname(spec), "benchmarks"))


def _traced(cell, monkeypatch):
    """A traced tiny run, and the Run its readers read."""
    runs = []
    real = harness.load_reader

    def load_reader(bench_dir, metric):
        read = real(bench_dir, metric)
        return lambda run: (runs.append(run), read(run))[1]
    monkeypatch.setattr(harness, "load_reader", load_reader)
    result = run_tiny(cell, seed=2**31 + 71, trace=True)
    assert result["correct"], result["check"]
    for k in ("rows_wrong", "rows_missing_or_extra", "calls_failed"):
        assert result["check"][k]["value"] == 0
    return result, runs[0]


def test_traced_tiny_run_reads_the_six_metrics(tiny16, monkeypatch):
    result, run = _traced(tiny16, monkeypatch)
    m = {k: v["value"] for k, v in result["metrics"].items()}
    counts = run.program["counts"]
    assert m["rdd_rows_per_event"] == counts["score.rows.rdd"] / \
        run.events > 0
    assert m["junction_share"] == counts["validate.junction"] / \
        run.events > 0
    assert m["host_scored_reads_per_event"] == 0.0
    assert "score.host_reads" not in counts
    assert m["validate_dup_ms_per_event"] > 0
    assert not set(DEVICE_READERS) & set(m)      # no card, no trace
    # the device readers on the profiler's names of this run's kernels
    run.device = {"by_name": {
        "void kept_hist_kernel<2>(unsigned int const*)": 0.002,
        "void rdd_moment_kernel<2>(unsigned int const*)": 0.003,
        "(anonymous namespace)::intercept_z_kernel(int const*)": 0.001,
        "void hist_kernel<2>(unsigned int const*)": 0.5}}
    assert run.bytes_by_route["rdd"] > 0
    assert _reader("rdd_kernel_ms_per_event")(run) == pytest.approx(
        1e3 * 0.006 / run.events)
    assert _reader("rdd_kernels_roofline")(run) == pytest.approx(
        100 * run.bytes_by_route["rdd"] / run.peaks["hbm_bytes_per_s"]
        / 0.006)


def test_traced_tiny_run_reads_every_metric_listing_the_cell(tiny16,
                                                            monkeypatch):
    """Every per-layer metric that lists the cell reads something in its
    traced run: on the CPU all but those of the device's trace."""
    result, _ = _traced(tiny16, monkeypatch)
    spec = _spec()
    listed = {m["name"] for m in spec["per_layer"]
              if CELL in m["workloads"] and m["source"] != "device_trace"}
    assert len(listed) == 24
    assert set(result["metrics"]) == listed


def test_program_without_the_new_sites_reads_nothing(tiny16, monkeypatch):
    """The parent's program: its recorder runs, but no validate.* span and
    no counter of the rows, the junction windows or the host's scoring;
    the new readers then read nothing and the run stays correct."""
    from vapor_tpu_torch.utils import trace
    real = trace.count
    new = ("score.", "validate.", "refine.host")
    monkeypatch.setattr(trace, "stepped", lambda name, gen: gen)
    monkeypatch.setattr(trace, "count", lambda name, n=1: None
                        if name.startswith(new) else real(name, n))
    result, run = _traced(tiny16, monkeypatch)
    assert run.program["counts"]["bam.records_parsed"] > 0
    assert all(_reader(n)(run) is None for n in PROGRAM_READERS)
    assert not set(PROGRAM_READERS) & set(result["metrics"])
