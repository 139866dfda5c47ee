"""The port's recorder (vapor_tpu_torch/utils/trace.py): off by default,
spans nested per thread with their parents, self time and event ids, no
span across a pipeline yield, and the CLI's span sites on a bed run."""
import io
import os
import threading

import pytest

from vapor_tpu_torch import cli
from vapor_tpu_torch.io import bai, reads as reads_mod
from vapor_tpu_torch.sim.scale import build_scale_case
from vapor_tpu_torch.utils import trace
from vapor_tpu_torch.utils.coro import drain, run_pipelined

# every span the program records, less batch.sync: it times
# done.synchronize() on a CUDA event, which a CPU run never records
SPANS = {"reads", "bam.inflate", "bam.parse", "bam.overlap", "reads.clip",
         "fetch", "dispatch", "refine", "pipeline.wait", "batch.flush",
         "emit", "cli.setup", "cli.finish"}


@pytest.fixture
def recorder():
    trace.reset()
    trace.enable()
    try:
        yield trace
    finally:
        trace.disable()
        trace.reset()


def _ancestors(spans, i):
    p = spans[i][3]
    while p >= 0:
        yield spans[p]
        p = spans[p][3]


def _crossing(spans):
    """Spans holding a span of another event: what a span left open
    across a pipeline yield would do."""
    return [s for i, s in enumerate(spans)
            for a in _ancestors(spans, i) if a[4] != s[4]]


def test_off_records_nothing():
    trace.reset()
    assert trace.span("a") is trace.span("b")
    with trace.span("a"):
        trace.count("n", 3)
        trace.set_event(4)
    assert trace.spanned("f")(lambda x: x + 1)(1) == 2

    def gen():
        yield lambda: 1

    drain(gen())
    snap = trace.snapshot()
    assert snap["spans"] == [] and snap["counts"] == {}


def test_nesting_parents_self_time_and_threads(recorder):
    opened, go = threading.Event(), threading.Event()

    def worker():
        with trace.span("t.outer"):
            opened.set()
            go.wait(10)
            with trace.span("t.inner"):
                pass

    with trace.span("m.outer"):
        th = threading.Thread(target=worker)
        th.start()
        assert opened.wait(10)
        with trace.span("m.inner"):
            trace.count("n")
        with trace.span("m.inner"):
            trace.count("n", 2)
        go.set()
        th.join(10)
    assert not th.is_alive()
    spans = trace.snapshot()["spans"]
    by = {}
    for i, s in enumerate(spans):
        by.setdefault(s[0], []).append(i)
    (mo,), (to,), (ti,) = by["m.outer"], by["t.outer"], by["t.inner"]
    assert [spans[i][3] for i in by["m.inner"]] == [mo, mo]
    assert spans[ti][3] == to and spans[to][3] == -1 and spans[mo][3] == -1
    assert spans[mo][5] == threading.get_ident() != spans[to][5]
    assert spans[ti][5] == spans[to][5]
    own = trace.self_times(spans)
    dur = [s[2] - s[1] for s in spans]
    assert own[mo] == dur[mo] - sum(dur[i] for i in by["m.inner"])
    assert own[to] == dur[to] - dur[ti]
    assert all(0 <= o <= d for o, d in zip(own, dur))
    assert trace.snapshot()["counts"] == {"n": 3}


def test_spans_open_at_snapshot_and_across_reset(recorder):
    with trace.span("outer"):
        snap = trace.snapshot()
        trace.reset()
        with trace.span("after"):
            pass
    assert snap["spans"][0][2] is None
    assert trace.self_times(snap["spans"]) == [0]
    (after,) = trace.snapshot()["spans"]
    assert after[0] == "after" and after[3] == -1


def test_snapshot_clock_pairs(recorder):
    snap = trace.snapshot()
    (w0, p0), (w1, p1) = snap["clock_at_enable"], snap["clock_at_snapshot"]
    assert p1 >= p0 and abs((w1 - w0) - (p1 - p0)) < 50_000_000
    assert snap["main_thread"] == threading.main_thread().ident


@pytest.mark.parametrize("depth", [1, 3])
def test_pipeline_event_ids_and_no_span_across_a_yield(recorder, depth):
    def task(i):
        def gen():
            for step in range(3):
                with trace.span("step"):
                    trace.count(f"task{i}")
                    fin = (lambda v=step: v)
                got = yield fin
                assert got == step
            return (i,)
        return gen

    emitted = []
    run_pipelined([task(i) for i in range(5)],
                  trace.spanned("emit")(emitted.append), depth)
    assert emitted == list(range(5))
    spans = trace.snapshot()["spans"]
    steps = [s for s in spans if s[0] == "step"]
    assert len(steps) == 15
    assert sorted(s[4] for s in steps) == sorted(list(range(5)) * 3)
    waits = [s for s in spans if s[0] == "pipeline.wait"]
    assert len(waits) == 15 and {s[4] for s in waits} == set(range(5))
    assert sorted(s[4] for s in spans if s[0] == "emit") == list(range(5))
    assert _crossing(spans) == []


def test_crossing_finds_a_span_left_open_across_a_yield(recorder):
    def held(i):
        def gen():
            with trace.span("held"):
                yield lambda: None
                with trace.span("inner"):
                    pass
            return (i,)
        return gen

    run_pipelined([held(i) for i in range(3)], lambda *a: None, 3)
    assert {s[0] for s in _crossing(trace.snapshot()["spans"])} \
        >= {"pipeline.wait"}


@pytest.fixture(scope="module")
def bed_case(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("trace"))
    case = build_scale_case(d, n_contigs=1, contig_len=30000, events_per=6,
                            reads_per=6, n_false_per=0, seed=9)
    case["dir"] = d
    return case


def _bed(case, out):
    reads_mod._open_bam.cache_clear()      # a fresh reader each run
    assert cli.main(["bed", "--sv-input", case["bed"], "--reference",
                     case["fasta"], "--pacbio-input", case["bam"],
                     "--output-path", os.path.join(case["dir"], "figs"),
                     "--output-file", out, "--device", "cpu",
                     "--no-figures", "--pipeline", "3"]) == 0
    with open(out, "rb") as fh:
        return fh.read()


def test_cli_writes_the_same_bytes_and_every_span(bed_case, recorder,
                                                  monkeypatch):
    trace.disable()
    off = _bed(bed_case, os.path.join(bed_case["dir"], "off.vapor"))
    parsed = []
    real = bai._parse_record

    def counted(*a):
        parsed.append(real(*a))
        return parsed[-1]

    monkeypatch.setattr(bai, "_parse_record", counted)
    trace.enable()
    on = _bed(bed_case, os.path.join(bed_case["dir"], "on.vapor"))
    trace.disable()
    assert on == off and on.count(b"\n") == 6
    snap = trace.snapshot()
    spans, main = snap["spans"], snap["main_thread"]
    assert SPANS <= {s[0] for s in spans}
    assert all(s[2] is not None for s in spans)
    for i, s in enumerate(spans):
        if s[0].startswith("bam.") or s[0] == "reads.clip":
            inside = any(a[0] == "reads" for a in _ancestors(spans, i))
            # off the main thread: the BAM prefetch reading the header
            assert inside or (s[5] != main and s[0] == "bam.inflate"), s
    assert _crossing(spans) == []
    assert {s[4] for s in spans if s[0] == "reads"} == set(range(5))
    assert snap["counts"]["bam.records_parsed"] == len(parsed) > 0
    assert snap["counts"]["bam.blocks_inflated"] >= 1
    assert 0 < snap["counts"]["bam.records_header_only"] <= len(parsed)
    assert 0 < snap["counts"]["reads.bases_decoded"] < sum(
        r.l_seq for r in parsed)
    out = io.StringIO()
    trace.report(out)
    text = out.getvalue()
    assert text.startswith("--- vapor-tpu-torch trace ---\n")
    assert "span reads " in text and " self=" in text
    assert f"count bam.records_parsed {len(parsed)}" in text
    assert "kernel hist launches=" in text
