"""Readers of the program's memory readings (benchmarks/memory.py and
the eight metrics that use it) on hand-built runs, and a tiny traced
run of the harness, whose snapshot carries the readings of set-up and
of the window."""
import pytest

from benchmarks import harness

from .conftest import run_tiny

MEMORY = ("rss_anon_mib", "rss_file_mib", "rss_shmem_mib",
          "rss_cuda_init_mib", "rss_kernel_load_mib", "pinned_host_mib",
          "rss_window_growth_mib", "warmup_call_s")
S = 1_000_000_000       # ns
MIB = 1024              # kB


def _reader(name):
    return harness.load_reader(harness.BENCH, name)


def _r(label, t, rss, hwm=None, anon=None, file=None, shmem=None,
       pinned=None, maxrss=5000):
    return {"label": label, "t_ns": t * S, "VmRSS": rss * MIB,
            "VmHWM": (hwm or rss) * MIB, "maxrss_kb": maxrss * MIB,
            "RssAnon": None if anon is None else anon * MIB,
            "RssFile": None if file is None else file * MIB,
            "RssShmem": None if shmem is None else shmem * MIB,
            "pinned_bytes": None if pinned is None else pinned * 2 ** 20}


def _snapshot(enable_s=10):
    """Import at 355 MiB, a warm-up call from 1 s to 4 s whose kernels
    load (a library: +30 MiB, its first launch: +20 MiB; a second
    library: +5 MiB, its launch's exit missing), the window from 10 s:
    two calls, the peak 130 MiB over the first call's entry."""
    mem = [_r("import", 0, 355, anon=300, file=50, shmem=5),
           _r("call.enter", 1, 4600, pinned=0),
           _r("kernel.load.hist.enter", 2, 4600),
           _r("kernel.load.hist.exit", 2.1, 4630),
           _r("kernel.first.hist.enter", 2.2, 4630),
           _r("kernel.first.hist.exit", 2.3, 4650),
           _r("kernel.load.moment.enter", 2.4, 4650),
           _r("kernel.load.moment.exit", 2.5, 4655),
           _r("kernel.first.moment.enter", 2.6, 4655),
           _r("call.exit", 4, 4800, anon=1000, file=3700, shmem=100,
              pinned=2),
           _r("call.enter", 11, 4810, hwm=4815, pinned=2),
           {"label": "smaps", "t_ns": 11 * S + 1,
            "rss_by_path_kb": [["[anon]", 1000 * MIB], ["other", 0]]},
           _r("call.exit", 12, 4850, hwm=4900, pinned=3),
           _r("call.enter", 13, 4850, hwm=4900, pinned=3),
           _r("call.exit", 14, 4820, hwm=4940, anon=990, file=3700,
              shmem=130, pinned=4)]
    return {"spans": [], "counts": {}, "main_thread": 1,
            "clock_at_enable": (0, enable_s * S),
            "clock_at_snapshot": (0, 15 * S), "memory": mem}


def _run(snap=None):
    run = harness.Run(setup_s=10.0, window_s=4.0, events=2, calls=[],
                      rss_mib=4940.0, trace=True)
    if snap is not None:
        run.program = snap
    return run


def test_readers_on_a_hand_built_run():
    got = {n: _reader(n)(_run(_snapshot())) for n in MEMORY}
    assert got == pytest.approx({
        "rss_anon_mib": 1000.0, "rss_file_mib": 3700.0,
        "rss_shmem_mib": 100.0, "rss_cuda_init_mib": 4245.0,
        "rss_kernel_load_mib": 55.0, "pinned_host_mib": 4.0,
        "rss_window_growth_mib": 130.0, "warmup_call_s": 3.0})


def test_readers_find_nothing_without_readings():
    """The parent's program takes no readings (its snapshot has no
    "memory"), or the recorder was never enabled: every reader returns
    None and none raises."""
    bare = _snapshot()
    del bare["memory"]
    never = dict(_snapshot(), clock_at_enable=None)
    empty = dict(_snapshot(), memory=[])
    for snap in (None, {}, bare, never, empty):
        for name in MEMORY:
            assert _reader(name)(_run(snap)) is None, (name, snap)


def test_readers_give_none_for_a_field_not_shown():
    """A kernel without the Rss* split (None in the readings), a process
    without CUDA (pinned None), no kernel loaded: None for each."""
    snap = _snapshot()
    snap["memory"] = [r for r in snap["memory"]
                      if not r["label"].startswith("kernel.")]
    for r in snap["memory"]:
        for f in ("RssAnon", "RssFile", "RssShmem", "pinned_bytes"):
            r[f] = None
    got = {n: _reader(n)(_run(snap)) for n in MEMORY}
    assert got == pytest.approx({
        "rss_anon_mib": None, "rss_file_mib": None, "rss_shmem_mib": None,
        "rss_cuda_init_mib": 4245.0, "rss_kernel_load_mib": None,
        "pinned_host_mib": None, "rss_window_growth_mib": 130.0,
        "warmup_call_s": 3.0})


def test_window_growth_takes_ru_maxrss_where_the_kernel_keeps_no_vmhwm():
    """No VmHWM (nor a reset of the peak): the peak is the process's
    ru_maxrss since its start, as the harness reads it, so the growth
    holds set-up's peak too (5000 MiB at the last exit, 4810 at the
    window's first entry)."""
    snap = _snapshot()
    for r in snap["memory"]:
        if "VmHWM" in r:
            r["VmHWM"] = None
    run = _run(snap)
    assert _reader("rss_window_growth_mib")(run) == pytest.approx(190.0)
    snap["memory"][-1]["maxrss_kb"] = None
    assert _reader("rss_window_growth_mib")(run) is None


def test_window_readers_without_a_window_call():
    """Enabled after the last call: the window's readers find nothing,
    the warm-up's read the last call before it."""
    run = _run(_snapshot(enable_s=20))
    assert _reader("pinned_host_mib")(run) is None
    assert _reader("rss_window_growth_mib")(run) is None
    assert _reader("rss_anon_mib")(run) == pytest.approx(990.0)
    assert _reader("warmup_call_s")(run) == pytest.approx(1.0)


def test_traced_tiny_run_carries_set_up_and_window_readings(tiny,
                                                            monkeypatch):
    """The snapshot of a tiny traced run on the CPU holds the CLI's
    import, the warm-up call's entry and exit before the window and two
    readings for each call of the window; the pinned figure and the
    kernels' loads are None without a card, every other reader reads."""
    load, _ = tiny
    runs = []
    real_load = harness.load_reader

    def load_reader(bench_dir, metric):
        read = real_load(bench_dir, metric)
        return lambda run: (runs.append(run), read(run))[1]
    monkeypatch.setattr(harness, "load_reader", load_reader)
    result = run_tiny(load("hg002_tier1.clr30x"), trace=True)
    assert result["correct"], result["check"]
    run = runs[0]
    mem = run.program["memory"]
    t0 = run.program["clock_at_enable"][1]
    before = [r["label"] for r in mem if r["t_ns"] < t0]
    window = [r["label"] for r in mem if r["t_ns"] >= t0]
    assert "import" in before
    assert before[-2:] == ["call.enter", "call.exit"]
    assert [x for x in window if x != "smaps"] == \
        ["call.enter", "call.exit"] * len(run.calls)
    assert window[1] == "smaps"
    assert all(r["pinned_bytes"] is None for r in mem if r["label"] !=
               "smaps")
    got = {n: _reader(n)(run) for n in MEMORY}
    assert got["pinned_host_mib"] is None
    assert got["rss_kernel_load_mib"] is None
    assert all(isinstance(got[n], float) for n in MEMORY
               if n not in ("pinned_host_mib", "rss_kernel_load_mib"))
    assert got["rss_anon_mib"] > 0 and got["rss_file_mib"] > 0
    assert 0 < got["warmup_call_s"] < run.setup_s
    assert got["rss_window_growth_mib"] >= 0
    assert set(n for n, v in got.items() if v is not None) <= \
        set(result["metrics"])
