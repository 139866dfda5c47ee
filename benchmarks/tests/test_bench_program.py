"""Readers of the program's own spans and counters (benchmarks/program.py
and the metrics that use it), the device summary and the routes' bound
(benchmarks/roofline.py), on hand-built runs and on tiny traced runs,
where the harness turns the program's recorder on around the window."""
import threading

import pytest

from benchmarks import harness, program, roofline

from .conftest import BED, run_tiny

MAIN, OTHER = 1, 2
MS = 1_000_000          # ns

READ_PARTS = ("read_inflate_ms_per_event", "read_parse_ms_per_event",
              "read_overlap_ms_per_event", "read_clip_ms_per_event",
              "read_gather_self_ms_per_event")
READERS = READ_PARTS + ("records_parsed_per_event",
                        "records_header_only_per_event",
                        "blocks_inflated_per_event",
                        "bases_decoded_per_event",
                        "launch_flush_ms_per_event",
                        "device_sync_ms_per_event",
                        "refine_host_ms_per_event",
                        "emit_ms_per_event",
                        "idle_unattributed_share")


def _reader(name):
    return harness.load_reader(harness.BENCH, name)


def _snapshot():
    """Two events' worth of spans, in ms: read gather [0, 100] with its
    four parts, a parse outside it and one on another thread, a wait
    holding a flush and a sync, a refiner stretch, a row written."""
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
         ("emit", 320, 324, -1, 1, MAIN),
         ("emit", 400, None, -1, 1, MAIN)]               # still open
    spans = [(n, a * MS, None if b is None else b * MS, p, e, t)
             for n, a, b, p, e, t in s]
    return {"spans": spans, "counts": {"bam.records_parsed": 92,
                                       "bam.records_header_only": 26,
                                       "bam.blocks_inflated": 28,
                                       "reads.bases_decoded": 42000},
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
        "records_header_only_per_event": 13.0,
        "blocks_inflated_per_event": 14.0,
        "bases_decoded_per_event": 21000.0,
        "launch_flush_ms_per_event": 15.0,
        "device_sync_ms_per_event": 5.0, "refine_host_ms_per_event": 5.0,
        "emit_ms_per_event": 2.0, "idle_unattributed_share": 0.25})
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
        "emit": 0.0, "unattributed": 0.1})
    assert sum(idle.values()) == pytest.approx(sum(e - s for s, e in gaps))


def _ops():
    """Device ops as torch.profiler names them, (name, start, end) in s:
    eleven kernels (more than the breakdown keeps), a copy and a memset,
    one op reaching past the window [0, 10]; idle until 0.5 s."""
    names = ["void hist_kernel<2>(unsigned int const*, int)",
             "void hist_self_kernel<2>(unsigned int const*, int)",
             "void left_hist_kernel<2>(unsigned int const*)",
             "void kept_hist_kernel<2>(unsigned int const*)",
             "void rdd_moment_kernel<2>(unsigned int const*)",
             "void moment_kernel<2>(unsigned int const*)",
             "void moment2_kernel<2>(unsigned int const*)",
             "(anonymous namespace)::row_codes_kernel(unsigned char const*)",
             "(anonymous namespace)::kept_tables_kernel(int const*)",
             "(anonymous namespace)::intercept_z_kernel(int const*)",
             "void at::native::vectorized_elementwise_kernel<4>(int)",
             "Memcpy HtoD (Pinned -> Device)", "Memset (Device)"]
    return [(n, 0.5 + 0.5 * i, 0.5 + 0.5 * i + 0.01 * (i + 1))
            for i, n in enumerate(names)] + [(names[0], 9.99, 10.5)]


def test_device_summary_keeps_every_op_and_idle_by_program():
    ops = _ops()
    snap = _snapshot()
    dev = harness._device_summary(ops, [], [], 0.0, 10.0, snap)
    assert len(dev["by_name"]) == 13
    assert len(dev["breakdown"]["device_ops"]) == 10
    inside = sum(min(e, 10.0) - s for _, s, e in ops)
    assert sum(dev["by_name"].values()) == pytest.approx(inside)
    copies = sum(v for n, v in dev["by_name"].items()
                 if n.startswith(("Memcpy", "Memset")))
    assert dev["kernel_s"] + copies == pytest.approx(inside)
    assert dev["by_name"][ops[0][0]] == pytest.approx(0.01 + 0.01)
    idle = dev["idle_by_program"]
    assert sum(idle.values()) == pytest.approx(10.0 - dev["busy_s"])
    assert idle["reads"] == pytest.approx(0.1 - 0.045)   # less its parts
    assert idle["refine"] == pytest.approx(0.01)
    assert "idle_by_program" not in harness._device_summary(
        ops, [], [], 0.0, 10.0, {})


@pytest.mark.parametrize("op,symbol", [
    ("void hist_kernel<2>(unsigned int const*, int)", "hist_kernel"),
    ("(anonymous namespace)::kept_tables_kernel(int const*)",
     "kept_tables_kernel"),
    ("void rdd_moment_kernel<2>(unsigned int const*)", "rdd_moment_kernel"),
    ("Memset (Device)", None),
])
def test_kernel_symbol(op, symbol):
    assert roofline.kernel_symbol(op) == symbol


def test_route_roofline_on_a_hand_built_run():
    run = _run(events=4)
    run.peaks = {"hbm_bytes_per_s": 1e9}
    run.device = harness._device_summary(_ops(), [], [], 0.0, 10.0)
    rdd = ("kept_hist", "rdd_moment", "intercept_z")
    seconds = 0.04 + 0.05 + 0.10                 # kernels 4, 5 and 10
    assert roofline.kernel_seconds(run.device["by_name"], rdd) == \
        pytest.approx(seconds)
    assert roofline.kernel_seconds(run.device["by_name"], ("hist",)) == \
        pytest.approx(0.02)                      # not hist_self's, left's
    assert roofline.route_ms_per_event(run, rdd) == \
        pytest.approx(1e3 * seconds / 4)
    assert roofline.route_roofline(run, "rdd", rdd) is None   # no bytes
    run.bytes_by_route = {"rdd": 10**6, "m1b": 5 * 10**6}
    assert roofline.route_roofline(run, "rdd", rdd) == \
        pytest.approx(100 * 1e-3 / seconds)
    assert roofline.route_roofline(run, "w10", ("moment",)) is None
    assert roofline.route_ms_per_event(_run(), rdd) is None  # untraced


def test_engine_kernels_roofline_reads_as_before():
    run = _run()
    run.peaks = {"hbm_bytes_per_s": 3.35e12}
    run.device = {"kernel_s": 0.3061}
    run.bytes_bound = 85_906_432
    bound_s = run.bytes_bound / run.peaks["hbm_bytes_per_s"]
    assert _reader("engine_kernels_roofline")(run) == \
        100.0 * bound_s / run.device["kernel_s"]
    assert _reader("engine_kernels_roofline")(_run()) is None


def _traced_run(tiny, monkeypatch, name):
    """A traced tiny run of the cell, and the Run its readers read."""
    load, _ = tiny
    runs = []
    real_load = harness.load_reader

    def load_reader(bench_dir, metric):
        read = real_load(bench_dir, metric)
        return lambda run: (runs.append(run), read(run))[1]
    monkeypatch.setattr(harness, "load_reader", load_reader)
    result = run_tiny(load(name), trace=True)
    assert result["correct"], result["check"]
    return result, runs[0]


@pytest.mark.parametrize("name", ["hg002_tier1.clr30x", BED])
def test_traced_tiny_run_with_the_program_recorder(tiny, monkeypatch,
                                                   name):
    """The harness's traced run turns the program's recorder on around
    its window: the snapshot holds spans and counters, the five parts of
    read gather sum to the program's read gather, which lies inside the
    outside span of the same name; launches by kernel sum to the
    launches, bytes by route to the bound's bytes."""
    from vapor_tpu_torch.utils import trace
    result, run = _traced_run(tiny, monkeypatch, name)
    snap = run.program
    assert snap["main_thread"] == threading.main_thread().ident
    assert snap["spans"] and snap["counts"]["bam.records_parsed"] > 0
    assert not trace._on and not trace._SPANS      # off and emptied after
    got = {n: _reader(n)(run) for n in READERS}
    assert got["idle_unattributed_share"] is None     # no card, no gaps
    assert got["device_sync_ms_per_event"] == 0.0     # CUDA events only
    parts = sum(got[n] for n in READ_PARTS)
    reads = 1e3 * program.span_seconds(snap, "reads") / run.events
    outside = 1e3 * run.spans["reads"] / run.events
    assert parts == pytest.approx(reads) and 0.8 * outside < reads <= outside
    assert got["records_parsed_per_event"] > got[
        "records_header_only_per_event"] > 0
    assert all(got[n] > 0 for n in (
        "read_parse_ms_per_event", "read_clip_ms_per_event",
        "launch_flush_ms_per_event", "refine_host_ms_per_event",
        "emit_ms_per_event", "blocks_inflated_per_event",
        "bases_decoded_per_event"))
    assert set(got) - {"idle_unattributed_share"} <= set(result["metrics"])
    assert sum(run.launches_by_kernel.values()) == run.launches
    assert set(run.bytes_by_route) <= {"m1b", "w10", "rdd", "del",
                                       "refiner"}
    assert "refiner" in run.bytes_by_route and "del" in run.bytes_by_route
    assert sum(run.bytes_by_route.values()) == run.bytes_bound > 0


def test_traced_run_of_a_program_without_the_recorder(tiny, monkeypatch):
    """A program whose recorder has no enable (older than its spans): the
    traced run still runs, and its readers find nothing to read."""
    from vapor_tpu_torch.utils import trace
    monkeypatch.delattr(trace, "enable")
    result, run = _traced_run(tiny, monkeypatch, "hg002_tier1.clr30x")
    assert run.program == {}
    assert all(_reader(n)(run) is None for n in READERS)
    assert not set(READERS) & set(result["metrics"])
    assert result["metrics"]["read_gather_ms_per_event"]["value"] > 0
