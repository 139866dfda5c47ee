"""Readers of the program's own spans and counters (benchmarks/program.py
and the metrics that use it), on hand-built runs and on a tiny traced
run with the program's recorder on."""
import threading

import pytest

from benchmarks import harness, program

from .conftest import BED, run_tiny

MAIN, OTHER = 1, 2
MS = 1_000_000          # ns

READ_PARTS = ("read_inflate_ms_per_event", "read_parse_ms_per_event",
              "read_overlap_ms_per_event", "read_clip_ms_per_event",
              "read_gather_self_ms_per_event")
READERS = READ_PARTS + ("records_parsed_per_event",
                        "launch_flush_ms_per_event",
                        "device_sync_ms_per_event",
                        "refine_host_ms_per_event",
                        "idle_unattributed_share")


def _reader(name):
    return harness.load_reader(harness.BENCH, name)


def _snapshot():
    """Two events' worth of spans, in ms: read gather [0, 100] with its
    four parts, a parse outside it and one on another thread, a wait
    holding a flush and a sync, a refiner stretch."""
    s = [("reads", 0, 100, -1, 0, MAIN),                 # 0
         ("bam.inflate", 5, 15, 0, 0, MAIN),
         ("bam.parse", 20, 40, 0, 0, MAIN),
         ("bam.overlap", 40, 45, 0, 0, MAIN),
         ("reads.clip", 50, 60, 0, 0, MAIN),
         ("bam.parse", 110, 130, -1, 1, MAIN),           # 5: not in reads
         ("bam.inflate", 0, 50, -1, -1, OTHER),          # prefetch
         ("pipeline.wait", 190, 260, -1, 1, MAIN),       # 7
         ("batch.flush", 200, 230, 7, 1, MAIN),
         ("batch.sync", 240, 250, 7, 1, MAIN),
         ("refine", 300, 310, -1, 1, MAIN),
         ("emit", 400, None, -1, 1, MAIN)]               # still open
    spans = [(n, a * MS, None if b is None else b * MS, p, e, t)
             for n, a, b, p, e, t in s]
    return {"spans": spans, "counts": {"bam.records_parsed": 92},
            "main_thread": MAIN, "clock_at_enable": (0, 0),
            "clock_at_snapshot": (0, 0)}


def _run(snap=None, idle=None, events=2):
    run = harness.Run(setup_s=1.0, window_s=1.0, events=events, calls=[],
                      rss_mib=1.0, trace=True)
    if snap is not None:
        run.program = snap
    if idle is not None:
        run.device["idle_by_program"] = idle
    return run


def test_readers_on_a_hand_built_run():
    got = {n: _reader(n)(_run(_snapshot(), idle={"reads": 3.0,
                                                 "unattributed": 1.0}))
           for n in READERS}
    assert got == pytest.approx({
        "read_inflate_ms_per_event": 5.0, "read_parse_ms_per_event": 10.0,
        "read_overlap_ms_per_event": 2.5, "read_clip_ms_per_event": 5.0,
        "read_gather_self_ms_per_event": 27.5,
        "records_parsed_per_event": 46.0,
        "launch_flush_ms_per_event": 15.0,
        "device_sync_ms_per_event": 5.0, "refine_host_ms_per_event": 5.0,
        "idle_unattributed_share": 0.25})
    assert sum(got[n] for n in READ_PARTS) == pytest.approx(50.0)


def test_readers_find_nothing_without_the_program_recorder():
    """The parent's program has no recorder: every reader returns None
    and none raises."""
    for name in READERS:
        assert _reader(name)(_run()) is None
        assert _reader(name)(_run(_snapshot(), events=0)) is None


def test_idle_by_program_span_takes_the_innermost_span():
    snap = _snapshot()
    gaps = [(0.0, 0.012), (0.195, 0.245), (0.5, 0.6)]
    idle = program.idle_by_program_span(gaps, snap)
    assert idle == pytest.approx({
        "reads": 0.005, "bam.inflate": 0.007, "bam.parse": 0.0,
        "bam.overlap": 0.0, "reads.clip": 0.0, "pipeline.wait": 0.015,
        "batch.flush": 0.030, "batch.sync": 0.005, "refine": 0.0,
        "unattributed": 0.1})
    assert sum(idle.values()) == pytest.approx(sum(e - s for s, e in gaps))


def test_traced_tiny_run_with_the_program_recorder(tiny, monkeypatch):
    """The harness's traced run with the recorder turned on around its
    window, as a harness that reads these metrics would: the five parts
    of read gather sum to the program's read gather, which lies inside
    the outside span of the same name."""
    from vapor_tpu_torch.utils import trace
    load, _ = tiny
    snap, runs = {}, []
    real_drive, real_load = harness.drive, harness.load_reader

    def drive(*a, **kw):
        trace.reset()
        trace.enable()
        try:
            return real_drive(*a, **kw)
        finally:
            snap.update(trace.snapshot())
            trace.disable()
            trace.reset()

    def load_reader(bench_dir, name):
        read = real_load(bench_dir, name)
        return lambda run: (runs.append(run), read(run))[1]

    monkeypatch.setattr(harness, "drive", drive)
    monkeypatch.setattr(harness, "load_reader", load_reader)
    result = run_tiny(load(BED), trace=True)
    assert result["correct"]
    run = runs[0]
    run.program = snap
    assert snap["main_thread"] == threading.main_thread().ident
    got = {n: _reader(n)(run) for n in READERS}
    assert got["idle_unattributed_share"] is None     # no card, no gaps
    assert got["device_sync_ms_per_event"] == 0.0     # CUDA events only
    parts = sum(got[n] for n in READ_PARTS)
    reads = 1e3 * program.span_seconds(snap, "reads") / run.events
    outside = 1e3 * run.spans["reads"] / run.events
    assert parts == pytest.approx(reads) and 0.8 * outside < reads <= outside
    assert got["records_parsed_per_event"] > 1
    assert all(got[n] > 0 for n in ("read_parse_ms_per_event",
                                    "read_clip_ms_per_event",
                                    "launch_flush_ms_per_event",
                                    "refine_host_ms_per_event"))
