"""Runs one cell of BENCHMARK.json once: set-up, window, check, result.

Set-up draws the cell's inputs from the seed (``gen``), builds the
program's kernels, and warms the program up with one call over the
first contig's lightest and heaviest call of each type.  The window
then calls the program until ``--seconds`` have passed: one
``vapor_tpu_torch.cli.main([...])`` a call, in this process, each over
one contig's call set, contigs in turn.

Every call reads the BAM, BAI, FASTA and FAI through fresh hard links at
a path no earlier call used, and the reader cache the program keeps per
path is emptied after it: no call finds warm state that a single-pass
run would not have.  A rate is all the events of completed calls over
the time from the window's start to the end of the last one.  Once the
window has closed, the rows of sampled events are compared with the
plain reference (``reference/``); the traced run (``--trace 1``)
wraps the program's primitives in spans (``spans.py``), turns the
program's own recorder on (``program.py``) and runs torch.profiler over
the window.  Each metric is read by the module of its name in
``metrics/``.

Every run prints to stderr, a line a call, what the host did in it (its
wall, the harness's time before it, the CPU seconds of the process and
of its main thread, context switches, major faults, gen-2 collections),
and the time of a fixed pure-Python loop before and after the window:
what a spread of the rate is traced to.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import resource
import shutil
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from typing import Dict, List, Optional

T_START = time.perf_counter()

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "vapor_tpu")


@dataclass
class Cell:
    name: str
    config: Dict
    traffic: Dict
    chips: int
    end_to_end: List[Dict]
    per_layer: List[Dict]
    bench_dir: str


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, spec_path: str = os.path.join(ROOT,
                                                       "BENCHMARK.json"),
              bench_dir: str = BENCH) -> Cell:
    """The cell `name` of the benchmark file, its configuration (the file
    that BENCHMARK.json names) and its traffic (traffic/<name>.json)."""
    with open(spec_path) as fh:
        spec = json.load(fh)
    cell = next((w for w in spec["workloads"] if w["name"] == name), None)
    if cell is None:
        raise KeyError(f"no workload {name!r} in {spec_path}")
    entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    root = os.path.dirname(os.path.abspath(spec_path))
    with open(os.path.join(root, entry["file"])) as fh:
        config = json.load(fh)
    with open(os.path.join(bench_dir, "traffic",
                           cell["traffic"] + ".json")) as fh:
        traffic = json.load(fh)
    return Cell(name, config, traffic, int(cell["chips"]),
                [m for m in spec["end_to_end"] if _applies(m, name)],
                [m for m in spec["per_layer"] if _applies(m, name)],
                bench_dir)


def load_reader(bench_dir: str, metric: str):
    """The metric's reader: metrics/<name>.py, whose read(run) returns
    the value, or None where the run holds nothing to read."""
    path = os.path.join(bench_dir, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmarks_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the
    JAX package (names compared whole: vapor_tpu_torch is not one)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


@contextlib.contextmanager
def quiet_stdout():
    """The program prints a line an event: send fd 1 (this process's and
    every child's) to /dev/null while it runs."""
    sys.stdout.flush()
    saved = os.dup(1)
    null = os.open(os.devnull, os.O_WRONLY)
    try:
        os.dup2(null, 1)
        yield
    finally:
        sys.stdout.flush()
        os.dup2(saved, 1)
        os.close(null)
        os.close(saved)


def work_root() -> str:
    base = os.environ.get("TMPDIR") or os.path.join(ROOT, ".bench_tmp")
    os.makedirs(base, exist_ok=True)
    return tempfile.mkdtemp(prefix="bench-", dir=base)


@dataclass
class Call:
    """One completed call of the window."""
    contigs: List[str]
    out: str
    argv: List[str]
    t0: float
    t1: float
    rc: int
    rows: Dict[str, List[str]] = field(default_factory=dict)
    host: Dict[str, float] = field(default_factory=dict)


class Gen2Timer:
    """Seconds and count of the collector's gen-2 collections while it is
    in gc.callbacks."""

    def __init__(self):
        self.seconds = 0.0
        self.count = 0
        self._start = None

    def __call__(self, phase: str, info: Dict) -> None:
        if info["generation"] != 2:
            return
        if phase == "start":
            self._start = time.perf_counter()
        elif self._start is not None:
            self.seconds += time.perf_counter() - self._start
            self.count += 1
            self._start = None


def host_sample(gen2: Gen2Timer) -> Dict[str, float]:
    """This process's CPU seconds (every thread) and its main thread's,
    context switches and major faults, and gen2's totals, now."""
    u = resource.getrusage(resource.RUSAGE_SELF)
    m = resource.getrusage(resource.RUSAGE_THREAD)
    return {"cpu_s": u.ru_utime + u.ru_stime,
            "main_cpu_s": m.ru_utime + m.ru_stime, "nvcsw": u.ru_nvcsw,
            "nivcsw": u.ru_nivcsw, "majflt": u.ru_majflt,
            "gc2_s": gen2.seconds, "gc2_n": gen2.count}


def calibrate(n: int = 3_000_000) -> float:
    """Seconds of a fixed pure-Python loop: the host's speed now."""
    t = time.perf_counter()
    s = 0
    for i in range(n):
        s += i & 7
    return time.perf_counter() - t


def _link(src: str, dst: str) -> str:
    os.link(src, dst)
    return dst


def fresh_inputs(inputs, dest: str, calls: str) -> Dict[str, str]:
    """Hard links of the reads, the reference and the call set in a new
    directory: paths that no earlier call used."""
    os.makedirs(dest)
    out = {"bam": _link(inputs.bam, os.path.join(dest, "reads.bam")),
           "fasta": _link(inputs.fasta, os.path.join(dest, "ref.fa")),
           "calls": _link(calls, os.path.join(dest, os.path.basename(calls)))}
    _link(inputs.bam + ".bai", out["bam"] + ".bai")
    _link(inputs.fasta + ".fai", out["fasta"] + ".fai")
    return out


def cli_argv(mode: str, paths: Dict[str, str], dest: str, traffic: Dict,
             device: str) -> List[str]:
    out_file = paths["calls"] + ".vapor" if mode == "vcf" \
        else os.path.join(dest, "out.vapor")
    return [mode, "--sv-input", paths["calls"], "--reference",
            paths["fasta"], "--pacbio-input", paths["bam"], "--output-path",
            os.path.join(dest, "figs"), "--output-file", out_file,
            "--no-figures", "--pipeline", str(traffic["pipeline"]),
            "--device", device]


def _forget_readers() -> None:
    """Empty the program's per-path BAM reader cache (io/reads.py)."""
    from vapor_tpu_torch.io import reads
    clear = getattr(getattr(reads, "_open_bam", None), "cache_clear", None)
    if clear is not None:
        clear()


def one_call(cli, inputs, work: str, n: int, calls: str,
             contigs: List[str], traffic: Dict, device: str,
             gen2: Optional[Gen2Timer] = None) -> Call:
    """One CLI call over the call set `calls`, through fresh links; with
    `gen2`, what the host did in it (host_sample's differences)."""
    dest = os.path.join(work, f"call{n}")
    paths = fresh_inputs(inputs, dest, calls)
    argv = cli_argv(inputs.mode, paths, dest, traffic, device)
    out = argv[argv.index("--output-file") + 1]
    h0 = host_sample(gen2) if gen2 is not None else None
    t0 = time.perf_counter()
    try:
        rc = cli.main(argv)
    except Exception:                   # a failed call, judged as one
        traceback.print_exc()
        rc = 1
    t1 = time.perf_counter()
    host = {}
    if h0 is not None:
        host = {k: v - h0[k] for k, v in host_sample(gen2).items()}
    _forget_readers()
    return Call(contigs, out, argv, t0, t1, rc, host=host)


def drive(cli, inputs, work: str, traffic: Dict, seconds: float,
          device: str, gen2: Gen2Timer, first: int = 1) -> List[Call]:
    """Calls, one after another, until `seconds` have passed: a contig's
    call set each, contigs in turn, each with what the host did in it."""
    names = list(inputs.lengths)
    calls: List[Call] = []
    deadline = time.perf_counter() + seconds
    n = first
    while time.perf_counter() < deadline:
        c = names[(n - first) % len(names)]
        calls.append(one_call(cli, inputs, work, n, inputs.per_contig[c],
                              [c], traffic, device, gen2))
        n += 1
    return calls


def warm_calls(inputs) -> str:
    """A call set of the first contig's lightest and heaviest call of
    each type, for the warm-up call: the kernels' libraries load, the
    CUDA context, the allocator and the pinned buffers grow to the
    window's sizes."""
    contig = list(inputs.lengths)[0]
    pick = set()
    for kind in {ev.kind for ev in inputs.events[contig]}:
        evs = sorted((ev for ev in inputs.events[contig] if ev.kind == kind),
                     key=lambda ev: ev.we - ev.ws + ev.size)
        pick |= {evs[0].svid, evs[-1].svid}
    src = inputs.per_contig[contig]
    path = os.path.join(inputs.root, "calls.warm." + inputs.mode)
    col = 2 if inputs.mode == "vcf" else 3
    with open(src) as fin, open(path, "w") as fout:
        for line in fin:
            if line.startswith("#") or line.split("\t")[col] in pick:
                fout.write(line)
    return path


def read_rows(call: Call, mode: str) -> Dict[str, List[str]]:
    """Output lines of a call by the call's ID (the VCF's column 3, the
    TSV's column 5), each ID with every line that carries it."""
    rows: Dict[str, List[str]] = {}
    if not os.path.exists(call.out):
        return rows
    col = 2 if mode == "vcf" else 4
    with open(call.out) as fh:
        for line in fh:
            if line.startswith("#") or not line.strip():
                continue
            cols = line.rstrip("\n").split("\t")
            if len(cols) > col:
                rows.setdefault(cols[col], []).append(line.rstrip("\n"))
    return rows


@dataclass
class Run:
    """What the metric readers read."""
    setup_s: float
    window_s: float
    events: int
    calls: List[Call]
    rss_mib: float
    trace: bool
    spans: Dict[str, float] = field(default_factory=dict)
    bytes_bound: int = 0
    bytes_by_route: Dict[str, int] = field(default_factory=dict)
    launches: Optional[int] = None
    launches_by_kernel: Dict[str, int] = field(default_factory=dict)
    launch_shapes: Dict[tuple, int] = field(default_factory=dict)
    device: Dict = field(default_factory=dict)
    peaks: Dict = field(default_factory=dict)
    program: Dict = field(default_factory=dict)


def host_rss_reset() -> bool:
    """Reset this process's peak RSS (Linux clear_refs 5)."""
    try:
        with open("/proc/self/clear_refs", "w") as fh:
            fh.write("5")
        return True
    except OSError:
        return False


def host_rss_peak_mib() -> float:
    """Peak RSS of this process since host_rss_reset (VmHWM), or since
    its start where the kernel keeps no VmHWM (ru_maxrss: set-up's
    warm-up call is then in it too)."""
    peak_kib = 0
    with open("/proc/self/status") as fh:
        for line in fh:
            if line.startswith("VmHWM:"):
                peak_kib = int(line.split()[1])
    if peak_kib == 0:
        peak_kib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return peak_kib / 1024.0


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda") -> Dict:
    """One run of the cell; returns the result line's object."""
    from . import gen
    work = work_root()
    try:
        t = time.perf_counter()
        inputs = gen.build(os.path.join(work, "data"), cell.config,
                           cell.traffic, seed)
        gen_s = time.perf_counter() - t
        print(f"setup: inputs drawn in {gen_s:.3f} s", file=sys.stderr)
        result = _measure(cell, inputs, work, seed, seconds, trace, device)
        result["gen_s"] = gen_s
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _recorder():
    """The program's recorder of spans and counters, or None where its
    version has none (vapor_tpu_torch.utils.trace without enable)."""
    try:
        from vapor_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace if hasattr(trace, "enable") else None


def _measure(cell, inputs, work, seed, seconds, trace, device) -> Dict:
    import torch
    from vapor_tpu_torch import cli
    from vapor_tpu_torch.engine import kernels
    from . import check, spans as spans_mod
    on_card = device == "cuda"
    if on_card:
        from vapor_tpu_torch.engine.kernels import build
        build.build()
        torch.zeros(1, device="cuda")
    with quiet_stdout():
        warm = one_call(cli, inputs, work, 0, warm_calls(inputs),
                        list(inputs.lengths)[:1], cell.traffic, device)
    if warm.rc != 0:
        raise RuntimeError(f"warm-up call exited {warm.rc}")
    spans = prof = recorder = None
    if trace:
        spans = spans_mod.Spans()
        spans.install()
        recorder = _recorder()
        if on_card:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
    calib_before = calibrate()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    gc.collect()
    host_rss_reset()
    launches0 = dict(kernels.LAUNCHES)
    shapes0 = kernels.LAUNCH_SHAPES.copy()
    gen2 = Gen2Timer()
    gc.callbacks.append(gen2)
    offset_ns = time.time_ns() - time.perf_counter_ns()
    if recorder is not None:
        recorder.reset()
        recorder.enable()
    t0 = time.perf_counter()
    setup_s = t0 - T_START
    snap: Dict = {}
    try:
        with quiet_stdout():
            calls = drive(cli, inputs, work, cell.traffic, seconds, device,
                          gen2)
    finally:
        if recorder is not None:
            snap = recorder.snapshot()
            recorder.disable()
            recorder.reset()
        gc.callbacks.remove(gen2)
        if spans is not None:
            spans.remove()
    t_end = calls[-1].t1
    if on_card:
        torch.cuda.synchronize()
    calib_after = calibrate()
    by_kernel = {k: n - launches0.get(k, 0)
                 for k, n in kernels.LAUNCHES.items()}
    dev = {}
    if prof is not None:
        prof.__exit__(None, None, None)
        dev = _device_summary(spans_mod.device_intervals(prof, offset_ns),
                              spans.intervals, calls, t0, t_end, snap)
        del prof
    rss = host_rss_peak_mib()
    device_info = {"platform": "cpu", "kind": "cpu", "count": 0,
                   "memory_peak_bytes": 0}
    if on_card:
        device_info = {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": cell.chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    for c in calls:
        c.rows = read_rows(c, inputs.mode)
    run = Run(setup_s, t_end - t0, sum(len(c.rows) for c in calls), calls,
              rss, trace, device=dev, peaks=_peaks(cell.bench_dir),
              program=snap)
    if spans is not None:
        run.spans = spans.span_totals()
        run.bytes_by_route = dict(spans.bytes_by_route)
        run.bytes_bound = sum(run.bytes_by_route.values())
        run.launches = sum(by_kernel.values())
        run.launches_by_kernel = by_kernel
        run.launch_shapes = dict(kernels.LAUNCH_SHAPES - shapes0)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers, detail = check.judge(cell, inputs, calls, seed)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_reader(cell.bench_dir, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if trace and on_card:
        device_info["busy_s"] = dev.get("busy_s", 0.0)
        device_info["window_s"] = run.window_s
    attempted = [ev.svid for call in calls for c in call.contigs
                 for ev in inputs.events[c]]
    result = {"correct": check.passed(numbers),
              "attempted": len(attempted),
              "failed": len(attempted) - run.events + sum(
                  len(c.rows) for c in calls if c.rc != 0),
              "metrics": metrics, "device": device_info}
    if trace and dev.get("breakdown"):
        result["breakdown"] = dev["breakdown"]
    result["check"] = numbers
    for line in host_lines(calls, t0, calib_before, calib_after):
        print(line, file=sys.stderr)
    print("window: " + " ".join(f"{c.t1 - c.t0:.3f}s/{len(c.rows)}"
                                for c in calls), file=sys.stderr)
    for line in detail:
        print(line, file=sys.stderr)
    return result


def host_lines(calls: List[Call], t0: float, calib_before: float,
               calib_after: float) -> List[str]:
    """A line a call of what the host did in it, and one for the run:
    the calibration loop's seconds before and after the window, the sums
    over the calls, the window and its rate of events."""
    lines, prev, tot = [], t0, {}
    for n, c in enumerate(calls, 1):
        h = dict(c.host, wall_s=c.t1 - c.t0, before_s=c.t0 - prev)
        prev = c.t1
        for k, v in h.items():
            tot[k] = tot.get(k, 0) + v
        lines.append(f"call {n}: events {len(c.rows)} " + _host_text(h))
    events = sum(len(c.rows) for c in calls)
    window = calls[-1].t1 - t0 if calls else 0.0
    rate = events / window if window > 0 else 0.0
    lines.append(f"host: calibration before {calib_before:.4f} s after "
                 f"{calib_after:.4f} s; calls {len(calls)} events "
                 f"{events} " + _host_text(tot) +
                 f" window_s {window:.4f} events_per_s {rate:.4f}")
    return lines


def _host_text(h: Dict[str, float]) -> str:
    return " ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in h.items())


def _peaks(bench_dir: str) -> Dict:
    with open(os.path.join(bench_dir, "peaks.json")) as fh:
        return json.load(fh)


def _device_summary(intervals, host, calls, t0, t_end,
                    snap: Optional[Dict] = None) -> Dict:
    """Busy seconds (their union), kernel seconds (copies and memsets
    left out), every device op's seconds by name (`by_name`), the idle
    seconds by the harness's spans and, where the program's recorder ran
    (`snap`), by the program's innermost span (`idle_by_program`), and
    the result line's breakdown: the ten busiest ops and idle causes."""
    from .program import idle_by_program_span
    from .spans import idle_by_span, idle_gaps, union_length
    busy = union_length(intervals, t0, t_end)
    kernel_s = 0.0
    by_name: Dict[str, float] = {}
    for name, s, e in intervals:
        d = min(e, t_end) - max(s, t0)
        if d <= 0:
            continue
        by_name[name] = by_name.get(name, 0.0) + d
        if not name.startswith(("Memcpy", "Memset")):
            kernel_s += d
    gaps = idle_gaps(intervals, t0, t_end)
    by_span = idle_by_span(gaps, host, [(c.t0, c.t1) for c in calls])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(by_span.items(), key=lambda kv: -kv[1])[:10]
    out = {"busy_s": busy, "kernel_s": kernel_s, "by_name": by_name,
           "breakdown": {"device_ops": [[n, v] for n, v in top],
                         "idle_gaps": [[n, v] for n, v in idle]}}
    if snap and snap.get("spans") is not None:
        out["idle_by_program"] = idle_by_program_span(gaps, snap)
    return out
