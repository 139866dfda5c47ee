"""The port's recorder (vapor_tpu_torch/utils/trace.py): off by default,
spans nested per thread with their parents, self time and event ids, no
span across a pipeline yield, the CLI's span sites on a bed run, and the
validators' spans and the scoring counters on a bed call set with
junction-mode events and a tandem DUP past the largest bucket; and the
memory readings: /proc status and smaps parsed, readings kept across
reset and bounded, each once-per-process label read once, the CLI's,
the kernel loader's and the first launch's sites."""
import io
import os
import threading
import time

import numpy as np
import pytest

from vapor_tpu_torch import cli
from vapor_tpu_torch.engine.constants import HAP_BUCKETS
from vapor_tpu_torch.grammar.letters import flank_length_calculate
from vapor_tpu_torch.io import bai, reads as reads_mod
from vapor_tpu_torch.sim import worklists
from vapor_tpu_torch.sim.scale import build_scale_case
from vapor_tpu_torch.utils import trace
from vapor_tpu_torch.utils.coro import drain, run_pipelined

# every span the program records, less batch.sync: it times
# done.synchronize() on a CUDA event, which a CPU run never records (and
# validate.ins: a bed run without INS calls)
SPANS = {"reads", "bam.inflate", "bam.parse", "bam.overlap", "reads.clip",
         "fetch", "dispatch", "refine", "pipeline.wait", "batch.flush",
         "emit", "cli.setup", "cli.finish", "validate.del", "validate.inv",
         "validate.dup"}
VALIDATE = ("validate.del", "validate.inv", "validate.dup", "validate.ins")
# what the validators run between their yields
CHILDREN = ("fetch", "reads", "refine", "dispatch")


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
    g = gen()
    assert trace.stepped("validate.del", g) is g
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


@pytest.mark.parametrize("depth", [1, 3])
def test_stepped_spans_each_stretch_between_yields(recorder, depth):
    """One span for each stretch of the generator between its yields, the
    spans of its body inside them, the pipeline's waits outside them, and
    its return value passed on."""
    def task(i):
        def body():
            for step in range(2):
                with trace.span("inner"):
                    fin = (lambda v=step: v)
                got = yield fin
                assert got == step
            return i

        def gen():
            return (i, (yield from trace.stepped("validate.dup", body())))
        return gen

    emitted = []
    run_pipelined([task(i) for i in range(4)],
                  lambda *a: emitted.append(a), depth)
    assert emitted == [(i, i) for i in range(4)]
    spans = trace.snapshot()["spans"]
    outer = [i for i, s in enumerate(spans) if s[0] == "validate.dup"]
    assert len(outer) == 4 * 3          # two yields: three stretches
    assert all(spans[i][3] in outer for i, s in enumerate(spans)
               if s[0] == "inner")
    assert all(s[3] == -1 for s in spans if s[0] == "pipeline.wait")
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


# (svtype, body): whole-event DEL, INV and DUP, a DEL and a DUP of 10 kb
# or more (junction mode), and a whole-event DUP whose alt haplotype,
# 2 x body + 2 x flank, passes the largest bucket: its refiner step and
# its reads go to the host
JUNCTION_EVENTS = (("DEL", 700), ("INV", 900), ("DUP", 800),
                   ("DEL", 12000), ("DUP", 11000), ("DUP", 8000))
LONG_DUP = 5
JUNCTION_READS = 6


@pytest.fixture(scope="module")
def junction_case(tmp_path_factory):
    """ref.fa, reads.bam and svs.bed of JUNCTION_EVENTS on one contig,
    JUNCTION_READS reads an event, half of them from the donor, and a
    second bed without the long DUP."""
    assert 2 * JUNCTION_EVENTS[LONG_DUP][1] + 2 * worklists.FLANK + 1 > \
        HAP_BUCKETS[-1]
    d = str(tmp_path_factory.mktemp("junction"))
    rng = np.random.default_rng(23)
    gap = 4000
    length = gap + sum(b * (2 if t == "DUP" else 1) + gap
                       for t, b in JUNCTION_EVENTS)
    ref = rng.integers(0, 4, length).astype(np.uint8)
    reads, rows, pos = [], [], gap
    for i, (svtype, body) in enumerate(JUNCTION_EVENTS):
        s0, e0 = pos, pos + body
        pos = e0 + gap + (body if svtype == "DUP" else 0)
        donor = worklists._donor(ref, svtype, s0, e0)
        # whole-event mode reads through the event's right flank (a DUP's
        # through s + 2 body + flank), junction mode around s (DEL) or
        # e (DUP)
        whole = body < 10000
        span = (2 * body if svtype == "DUP" else body) if whole else 0
        anchor = e0 if svtype == "DUP" and not whole else s0
        read_len = span + 2 * worklists.FLANK + 1500
        for r in range(JUNCTION_READS):
            start = anchor - worklists.FLANK - int(rng.integers(200, 600))
            from_donor = r % 2 == 0
            template = (donor if from_donor else ref)[start:start + read_len]
            seq, cigar = worklists.noisy_read(template, rng, 0.02)
            reads.append((0, start, seq, f"{seq.size}M" if from_donor
                          else cigar))
        rows.append(f"chrE\t{s0}\t{e0}\tSV{i}\t{svtype}\n")
    fa, bam = worklists._write(d, [ref], reads)
    beds = {}
    for name, keep in (("all", rows),
                       ("short", rows[:LONG_DUP] + rows[LONG_DUP + 1:])):
        beds[name] = os.path.join(d, name + ".bed")
        with open(beds[name], "w") as fh:
            fh.write("".join(keep))
    return {"dir": d, "fasta": fa, "bam": bam, "beds": beds, "rows": rows}


def _run_bed(case, bed, out):
    """The bed CLI on `bed` through the batching backend, a fresh BAM
    reader; returns the output's bytes."""
    reads_mod._open_bam.cache_clear()
    argv = ["bed", "--sv-input", bed, "--reference", case["fasta"],
            "--pacbio-input", case["bam"], "--output-path",
            os.path.join(case["dir"], "figs"), "--output-file", out,
            "--device", "cpu", "--no-figures", "--pipeline", "3"]
    assert cli.main(argv) == 0
    with open(out, "rb") as fh:
        return fh.read()


def _kept(case, chrom, start, end, flank):
    reads_mod._open_bam.cache_clear()
    return len(reads_mod.collect_event_reads(case["bam"], chrom, start, end,
                                             flank, 20))


def test_bed_validators_spans_and_counters(junction_case, recorder):
    """validate.* spans hold their validator's fetch, reads, refine and
    dispatch and never a pipeline wait or another event's work; the rdd
    route's rows are the whole-event DUPs' kept reads on two haplotypes;
    the junction-mode events are counted; the host scores only the long
    DUP's reads and refines only its alt haplotype; the rows equal those
    of a run with the recorder off."""
    case = junction_case
    trace.disable()
    off = _run_bed(case, case["beds"]["all"],
                   os.path.join(case["dir"], "off.vapor"))
    trace.enable()
    on = _run_bed(case, case["beds"]["all"],
                  os.path.join(case["dir"], "on.vapor"))
    trace.disable()
    assert on == off
    assert off.count(b"\nchrE\t") == len(JUNCTION_EVENTS)
    assert b"\tNA\t" not in off           # every event scored
    snap = trace.snapshot()
    spans, counts = snap["spans"], snap["counts"]
    names = {s[0] for s in spans}
    assert {"validate.del", "validate.inv", "validate.dup"} <= names
    assert "validate.ins" not in names
    assert _crossing(spans) == []
    for i, s in enumerate(spans):
        up = [a[0] for a in _ancestors(spans, i)]
        if s[0] in VALIDATE or s[0] == "pipeline.wait":
            assert not set(up) & set(VALIDATE + ("pipeline.wait",)), s
        elif s[0] in CHILDREN:
            assert set(up) & set(VALIDATE), s
    dups = [(int(r.split()[1]), int(r.split()[2])) for r in case["rows"]
            if r.split()[4] == "DUP"]
    device_dups = [(s, e) for s, e in dups if e - s < 10000 and
                   2 * (e - s) + 2 * flank_length_calculate(["", s, e]) + 1
                   <= HAP_BUCKETS[-1]]
    assert len(device_dups) == 1
    rows = 0
    for s, e in device_dups:
        f = flank_length_calculate(["chrE", s, e])
        rows += 2 * _kept(case, "chrE", s - f, s + 2 * (e - s) + f, f)
    assert counts["score.rows.rdd"] == rows > 0
    assert counts["validate.junction"] == 2
    s, e = dups[-1]
    f = flank_length_calculate(["chrE", s, e])
    assert counts["score.host_reads"] == _kept(
        case, "chrE", s - f, s + 2 * (e - s) + f, f) > 0
    assert counts["refine.host"] == 1
    assert {"score.rows.del", "score.rows.w10"} <= set(counts)
    assert "score.rows.m1b" in counts          # the whole-event INV

    trace.reset()
    trace.enable()
    short = _run_bed(case, case["beds"]["short"],
                     os.path.join(case["dir"], "short.vapor"))
    trace.disable()
    counts = trace.snapshot()["counts"]
    assert "score.host_reads" not in counts and "refine.host" not in counts
    assert counts["score.rows.rdd"] == rows
    assert sorted(short.splitlines()) == sorted(
        line for line in off.splitlines() if b"\tSV5\t" not in line)


def test_vcf_validators_spans_keep_the_golden(tmp_path, recorder):
    """vcf mode steps its DEL, INV and INS validators under their spans
    (tandem DUPs emit no row there), and its rows stay the golden's."""
    from vapor_tpu_torch.sim import goldens
    reads_mod._open_bam.cache_clear()
    got = goldens.run_golden("vcf_all_types", str(tmp_path), device="cpu")
    trace.disable()
    assert got == goldens.golden_text("vcf_all_types")
    spans = trace.snapshot()["spans"]
    names = {s[0] for s in spans}
    assert {"validate.del", "validate.inv", "validate.ins"} <= names
    assert "validate.dup" not in names
    assert _crossing(spans) == []
    for i, s in enumerate(spans):
        if s[0] in VALIDATE:
            assert not {a[0] for a in _ancestors(spans, i)} & set(VALIDATE)


# ---------------------------------------------------------------------------
# memory readings
# ---------------------------------------------------------------------------

STATUS = """Name:\tpython3
VmPeak:\t 9000000 kB
VmHWM:\t 5100000 kB
VmRSS:\t 4983000 kB
RssAnon:\t 1200000 kB
RssFile:\t 3700000 kB
RssShmem:\t   83000 kB
VmSwap:\t       0 kB
"""


@pytest.fixture
def memory(monkeypatch):
    """The recorder's memory readings emptied for the test alone."""
    monkeypatch.setattr(trace, "_mem_first", {})
    monkeypatch.setattr(trace, "_mem_recent",
                        trace.collections.deque(maxlen=trace.MEMORY_KEEP))
    monkeypatch.setattr(trace, "_by_path", None)
    monkeypatch.setattr(trace, "_by_path_due", False)
    return trace


def _labels(readings):
    return [r["label"] for r in readings]


def test_parse_status_reads_the_five_fields():
    assert trace.parse_status(STATUS) == {
        "VmRSS": 4983000, "VmHWM": 5100000, "RssAnon": 1200000,
        "RssFile": 3700000, "RssShmem": 83000}


def test_parse_status_gives_none_for_a_field_not_shown():
    """A kernel older than the Rss* split shows VmRSS and VmHWM alone:
    the three components are None, not 0."""
    old = "\n".join(line for line in STATUS.splitlines()
                    if not line.startswith("Rss"))
    assert trace.parse_status(old) == {
        "VmRSS": 4983000, "VmHWM": 5100000, "RssAnon": None,
        "RssFile": None, "RssShmem": None}
    assert trace.parse_status("") == dict.fromkeys(trace.STATUS_FIELDS)


def test_a_reading_of_this_process(memory):
    trace.memory("x")
    (r,) = trace.memory_readings()
    assert r["label"] == "x" and r["t_ns"] <= time.perf_counter_ns()
    assert r["split_from"] == "status"
    assert r["VmRSS"] > 0 and r["VmHWM"] >= r["VmRSS"]
    assert abs(r["RssAnon"] + r["RssFile"] + r["RssShmem"] - r["VmRSS"]) \
        <= 0.02 * r["VmRSS"]
    assert r["maxrss_kb"] >= r["VmRSS"]
    assert r["pinned_bytes"] is None             # CUDA never initialised


def test_readings_survive_reset_and_stay_bounded(memory):
    """Readings are taken with the recorder off, reset() leaves them, the
    first of each label stays, and 10,000 calls keep MEMORY_KEEP more."""
    trace.disable()
    trace.memory("import", once=True)
    trace.memory("kernel.load.hist.enter", once=True)
    trace.memory("kernel.load.hist.exit", once=True)
    for _ in range(10_000):
        trace.memory("call.enter")
        trace.memory("call.exit")
        trace.memory("import", once=True)
        trace.memory("kernel.load.hist.enter", once=True)
    trace.reset()
    got = trace.snapshot()["memory"]
    assert len(got) == 5 + trace.MEMORY_KEEP
    labels = _labels(got)
    assert labels[:5] == ["import", "kernel.load.hist.enter",
                          "kernel.load.hist.exit", "call.enter",
                          "call.exit"]
    assert labels.count("import") == 1
    assert labels.count("kernel.load.hist.enter") == 1
    assert labels[-2:] == ["call.enter", "call.exit"]
    t = [r["t_ns"] for r in got]
    assert t == sorted(t)


def test_distinct_labels_past_the_kept_limit_stay_bounded(memory):
    for n in range(1000):
        trace.memory(f"kernel.first.k{n}.enter", once=True)
    assert len(trace.memory_readings()) == trace._KEPT_MAX


def test_each_once_label_fires_once_across_threads(memory):
    threads = [threading.Thread(target=lambda: [
        trace.memory("kernel.first.hist.enter", once=True)
        for _ in range(50)]) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(10)
    assert _labels(trace.memory_readings()) == ["kernel.first.hist.enter"]


SMAPS = """55d0c0000000-55d0c0021000 r--p 00000000 08:01 1234 /usr/bin/python3
Size:                132 kB
Rss:                 100 kB
Pss:                 100 kB
VmFlags: rd mr mw me dw
7f0000000000-7f0000100000 rw-p 00000000 00:00 0
Size:               1024 kB
Rss:                1000 kB
7f0000200000-7f0000300000 r-xp 00000000 08:01 99 /usr/lib/libcuda.so.1
Rss:                2000 kB
7f0000300000-7f0000400000 r--p 00100000 08:01 99 /usr/lib/libcuda.so.1
Rss:                  50 kB
7f0000500000-7f0000600000 rw-p 00000000 00:00 0   [heap]
Rss:                 300 kB
7f0000600000-7f0000700000 rw-s 00000000 00:05 7   /dev/shm/a b (deleted)
Rss:                  20 kB
"""


def test_parse_smaps_and_the_status_split_from_it():
    maps = trace.parse_smaps(SMAPS.splitlines(True))
    assert maps == [["/usr/bin/python3", 100, 0], ["[anon]", 1000, 0],
                    ["/usr/lib/libcuda.so.1", 2000, 0],
                    ["/usr/lib/libcuda.so.1", 50, 0], ["[heap]", 300, 0],
                    ["/dev/shm/a b (deleted)", 20, 0]]
    maps[0][2] = 40                     # copied-on-write pages of a file
    maps[1][2], maps[4][2] = 1000, 300
    assert trace.split_of(maps) == {"RssAnon": 1340, "RssFile": 2110,
                                    "RssShmem": 20}


def test_split_from_smaps_where_the_status_lacks_it(memory, monkeypatch):
    """A kernel whose status shows no Rss* split: the first import,
    call.enter and call.exit take it from smaps, once each; later ones
    and the kernels' readings keep None."""
    bare = "\n".join(line for line in STATUS.splitlines()
                     if not line.startswith("Rss"))
    monkeypatch.setattr(trace, "_status",
                        lambda: trace.parse_status(bare))
    reads = []
    monkeypatch.setattr(trace, "_smaps", lambda: reads.append(1) or [
        ["[heap]", 300, 300], ["/lib/a.so", 2000, 10],
        ["/dev/nvidiactl", 64, 0]])
    for label in ("import", "call.enter", "kernel.load.hist.enter",
                  "call.exit", "call.enter", "call.exit"):
        trace.memory(label)
    got = trace.memory_readings()
    assert len(reads) == 3
    assert [r["split_from"] for r in got] == ["smaps", "smaps", None,
                                              "smaps", None, None]
    assert {k: got[0][k] for k in ("RssAnon", "RssFile", "RssShmem")} == \
        {"RssAnon": 310, "RssFile": 1990, "RssShmem": 64}
    assert got[-1]["RssAnon"] is None and got[-1]["VmRSS"] == 4983000


def test_memory_by_path_once_after_enable(memory, monkeypatch, tmp_path):
    """Off: nothing.  The first call after enable() keeps the TOP_PATHS
    largest paths and the rest as "other"; a second call reads nothing
    until the next enable(); a missing smaps is recorded as None."""
    trace.memory_by_path()
    assert trace.memory_readings() == []
    smaps = "".join(
        f"7f{n:010x}-7f{n + 1:010x} r--p 0 08:01 {n} /lib/l{n}.so\n"
        f"Rss: {n + 1} kB\n" for n in range(20))
    path = tmp_path / "smaps"
    path.write_text(smaps)
    real_open = open

    def fake_open(name, *a, **kw):
        if name == "/proc/self/smaps":
            return real_open(path, *a, **kw)
        return real_open(name, *a, **kw)
    monkeypatch.setattr("builtins.open", fake_open)
    trace.enable()
    try:
        trace.memory_by_path()
        trace.memory_by_path()
        (r,) = trace.memory_readings()
        assert r["label"] == "smaps"
        top = r["rss_by_path_kb"]
        assert top[:trace.TOP_PATHS] == [[f"/lib/l{n}.so", n + 1]
                                         for n in range(19, 7, -1)]
        assert top[-1] == ["other", sum(range(1, 9))]
        path.unlink()
        trace.enable()
        trace.memory_by_path()
        (r,) = trace.memory_readings()
        assert r["rss_by_path_kb"] is None
    finally:
        trace.disable()


def test_cli_call_takes_its_readings_and_the_report_prints_them(
        memory, tmp_path):
    """cli.main reads at entry and at exit, also where it returns early;
    the report prints every reading."""
    missing = str(tmp_path / "none.fa")
    for _ in range(2):
        assert cli.main(["bed", "--sv-input", missing, "--reference",
                         missing, "--pacbio-input", missing,
                         "--output-path", str(tmp_path), "--device",
                         "cpu"]) == 2
    assert _labels(trace.memory_readings()) == ["call.enter", "call.exit"] * 2
    trace.memory("import", once=True)
    out = io.StringIO()
    trace.report(out)
    lines = [x for x in out.getvalue().splitlines()
             if x.startswith("memory ")]
    assert len(lines) == 5 and "pinned=-" in lines[0]
    assert "VmRSS=" in lines[-1] and "maxrss_kb=" in lines[-1]


def test_kernel_load_and_first_launch_read_once(memory, monkeypatch,
                                                tmp_path):
    """A library's load is read around its first ctypes.CDLL, once
    however many of its symbols are bound; an entry point's first call
    around that call, once."""
    import ctypes

    import torch

    from vapor_tpu_torch.engine import kernels
    from vapor_tpu_torch.engine.kernels import build
    lib = tmp_path / "fake.so"
    lib.write_bytes(b"")
    loads = []

    class Lib:
        def __init__(self, path):
            loads.append(path)

        def __getattr__(self, symbol):
            return lambda *a: 0
    monkeypatch.setattr(build, "library_path", lambda name: str(lib))
    monkeypatch.setattr(ctypes, "CDLL", Lib)
    monkeypatch.setattr(build, "_loaded", {})
    build.entry_point("hist")
    build.entry_point("hist", "selfstats")
    assert loads == [str(lib)] * 2
    assert _labels(trace.memory_readings()) == ["kernel.load.hist.enter",
                                                "kernel.load.hist.exit"]
    monkeypatch.setattr(kernels, "_ENTRY", {})
    monkeypatch.setattr(kernels, "LAUNCHES", dict(kernels.LAUNCHES))
    monkeypatch.setattr(kernels, "LAUNCH_SHAPES", kernels.Counter())
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 0, raising=False)
    x = torch.zeros(1)
    for _ in range(3):
        kernels._launch_glue("intercept_z", (8, 8), x)
        kernels._launch("hist", x, x, x, x, x, 1, 8, 8, route="selfstats")
    assert _labels(trace.memory_readings())[2:] == [
        "kernel.load.intercept_z.enter", "kernel.load.intercept_z.exit",
        "kernel.first.intercept_z.enter", "kernel.first.intercept_z.exit",
        "kernel.first.hist_self.enter", "kernel.first.hist_self.exit"]
    assert kernels.LAUNCHES["hist"] == kernels.LAUNCHES["intercept_z"] == 3
