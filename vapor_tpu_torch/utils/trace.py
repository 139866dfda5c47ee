"""The port's recorder of spans and counters (``--trace``).

A span site is ``with span("name"):`` (or ``@spanned("name")`` on a
function); a counter site is ``count("name", n)``.  The recorder is off
by default: a site then costs one check of a module global and, for a
span, enters a shared no-op context.  ``enable()`` turns it on (the
CLI's ``--trace``, or the benchmark around its traced window).

Each span is one tuple in a module-level list,
``(name, t0_ns, t1_ns, parent_index, event_id, thread_id)``, stamped
with ``time.perf_counter_ns()``: the clock the benchmark stamps its
calls with and maps the card's Kineto trace onto.  The parent is the
innermost span open on the same thread then (-1 for none); each thread
keeps its own stack, so spans on the band-QC workers and the BAM
prefetch thread nest apart from the main thread's.  The event id is the
one the pipeline last set on that thread (``set_event``; -1 for none),
so the spans of one event share it while 24 events interleave.  A span
still open at ``snapshot`` has ``t1_ns`` None.

No span stays open across a ``yield`` of a validator or refiner
generator: the pipeline steps other events between yields, and such a
span would time their work.  ``stepped`` times a whole generator that
way, one span for each stretch between its yields.

Memory readings (``memory``) are taken whether or not the recorder is
on, at a bounded number of sites: once when the CLI module has been
imported, at entry to and exit from each ``cli.main``, around each
kernel library's load and each C entry point's first call.  A reading is
a dict of its label, ``perf_counter_ns``, the kB of ``VmRSS``,
``VmHWM``, ``RssAnon``, ``RssFile`` and ``RssShmem`` from
``/proc/self/status`` (None for a field the kernel does not show; the
first ``import``, ``call.enter`` and ``call.exit`` take the three
``Rss*`` from ``/proc/self/smaps`` instead), the
process's peak resident kB since its start (``maxrss_kb``, getrusage's
``ru_maxrss``: the peak where the kernel keeps no ``VmHWM``) and the
bytes torch's caching host allocator holds (``pinned_bytes``; None
before CUDA is initialised).  The first reading of each label is kept
for the process, later ones among the ``MEMORY_KEEP`` most recent;
``reset`` leaves them all, so set-up's readings reach the window's
snapshot.  The first ``cli.main`` after ``enable`` also reads the
resident kB by mapped path (``memory_by_path``).
"""
from __future__ import annotations

import collections
import functools
import resource
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

_on = False
_SPANS: List[Tuple] = []
_COUNTS: Dict[str, int] = {}
# guards the slot a span takes in _SPANS, and the counters
_lock = threading.Lock()
_clock_at_enable: Optional[Tuple[int, int]] = None

STATUS_FIELDS = ("VmRSS", "VmHWM", "RssAnon", "RssFile", "RssShmem")
MEMORY_KEEP = 384           # later readings kept, the most recent
_KEPT_MAX = 128             # labels whose first reading is kept
TOP_PATHS = 12              # mappings memory_by_path names
# labels whose first reading takes RssAnon, RssFile and RssShmem from
# smaps where the status does not show them: one read each a process,
# none inside the warm-up call's kernel loads
SPLIT_LABELS = ("import", "call.enter", "call.exit")
_mem_first: Dict[str, Dict] = {}
_mem_recent: collections.deque = collections.deque(maxlen=MEMORY_KEEP)
_by_path: Optional[Dict] = None
_by_path_due = False


class _Thread(threading.local):
    def __init__(self):
        self.stack: List["_Span"] = []
        self.event = -1


_tls = _Thread()


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Span:
    __slots__ = ("name", "spans", "index", "stack")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        tls = _tls
        stack = tls.stack
        top = stack[-1] if stack else None
        spans = _SPANS
        # a span opened before reset() is no parent of one opened after
        parent = top.index if top is not None and top.spans is spans \
            else -1
        t0 = time.perf_counter_ns()
        with _lock:
            self.index = len(spans)
            spans.append((self.name, t0, None, parent, tls.event,
                          threading.get_ident()))
        self.spans = spans
        self.stack = stack
        stack.append(self)
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.stack.pop()
        name, t0, _, parent, event, tid = self.spans[self.index]
        self.spans[self.index] = (name, t0, t1, parent, event, tid)
        return False


def span(name: str):
    """A context manager that records one span of `name`."""
    if not _on:
        return _NOOP
    return _Span(name)


def spanned(name: str):
    """Decorator form of `span`: each call of the function is a span of
    `name` (the recorder is checked at each call, not at decoration)."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return run
    return wrap


def stepped(name: str, gen):
    """`gen`, a generator of finishers (utils/coro.py), with each
    stretch of it between two yields timed as a span of `name`: the span
    closes before each yield, so the waits that the pipeline resolves in
    between stay outside it.  With the recorder off, `gen` itself (the
    recorder is checked here, once a generator)."""
    if not _on:
        return gen
    return _stepped(name, gen)


def _stepped(name: str, gen):
    value = None
    while True:
        with span(name):
            try:
                fin = gen.send(value)
            except StopIteration as stop:
                return stop.value
        value = yield fin


def count(name: str, n: int = 1) -> None:
    """Adds `n` to the counter `name`."""
    if not _on:
        return
    with _lock:
        _COUNTS[name] = _COUNTS.get(name, 0) + n


def set_event(event_id: int) -> None:
    """The event whose work this thread does from now on."""
    if _on:
        _tls.event = event_id


def _clock() -> Tuple[int, int]:
    return time.time_ns(), time.perf_counter_ns()


def enable() -> None:
    global _on, _clock_at_enable, _by_path_due
    _clock_at_enable = _clock()
    _by_path_due = True
    _on = True


def disable() -> None:
    global _on
    _on = False


def reset() -> None:
    """Forgets every span and counter (call it with no span open)."""
    global _SPANS
    with _lock:
        _SPANS = []
        _COUNTS.clear()


def parse_status(text: str) -> Dict[str, Optional[int]]:
    """The kB of each of STATUS_FIELDS in the text of /proc/<pid>/status,
    None for a field it does not show."""
    out: Dict[str, Optional[int]] = dict.fromkeys(STATUS_FIELDS)
    for line in text.splitlines():
        key, _, rest = line.partition(":")
        if key in out:
            out[key] = int(rest.split()[0])
    return out


def _status() -> Dict[str, Optional[int]]:
    try:
        with open("/proc/self/status") as fh:
            return parse_status(fh.read())
    except OSError:
        return dict.fromkeys(STATUS_FIELDS)


def _pinned_bytes() -> Optional[int]:
    """Bytes torch's caching host allocator holds (in use and cached),
    where this process has initialised CUDA; else None."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return None
    stats_of = getattr(torch.cuda, "host_memory_stats", None)
    if stats_of is None:
        return None
    stats = stats_of()
    # reserved_bytes up to torch 2.11; from 2.13 allocated_bytes counts
    # the blocks the allocator holds, cached ones included
    for key in ("reserved_bytes.current", "allocated_bytes.current"):
        if key in stats:
            return int(stats[key])
    return None


def memory(label: str, once: bool = False) -> None:
    """Takes a memory reading `label`, the recorder on or off; with
    `once`, only where no reading of `label` was taken before.  Its
    ``split_from`` says where RssAnon, RssFile and RssShmem came from:
    "status", "smaps" (the first reading of a label of SPLIT_LABELS,
    where the status does not show them) or None."""
    if once and label in _mem_first:
        return
    t = time.perf_counter_ns()
    status = _status()
    split_from = "status" if status["RssAnon"] is not None else None
    if split_from is None and label in SPLIT_LABELS and \
            label not in _mem_first:
        maps = _smaps()
        if maps is not None:
            status.update(split_of(maps))
            split_from = "smaps"
    reading = {"label": label, "t_ns": t, **status,
               "split_from": split_from,
               "maxrss_kb": resource.getrusage(
                   resource.RUSAGE_SELF).ru_maxrss,
               "pinned_bytes": _pinned_bytes()}
    with _lock:
        if label not in _mem_first and len(_mem_first) < _KEPT_MAX:
            _mem_first[label] = reading
        elif not once:
            _mem_recent.append(reading)


def parse_smaps(lines) -> List[List]:
    """[path, resident kB, anonymous kB] of each mapping in the lines of
    /proc/<pid>/smaps; an anonymous mapping's path is "[anon]"."""
    maps: List[List] = []
    for line in lines:
        head, _, rest = line.partition(" ")
        if not head.endswith(":"):          # a mapping's first line
            fields = line.split(None, 5)
            maps.append([fields[5].strip() if len(fields) > 5
                         else "[anon]", 0, 0])
        elif maps and head == "Rss:":
            maps[-1][1] = int(rest.split()[0])
        elif maps and head == "Anonymous:":
            maps[-1][2] = int(rest.split()[0])
    return maps


def split_of(maps) -> Dict[str, int]:
    """RssAnon, RssFile and RssShmem in kB from smaps' mappings, as
    Linux's status counts them: the anonymous pages; the rest of each
    mapping of a file outside /dev; the rest of every other mapping
    (shared memory, devices)."""
    anon = sum(m[2] for m in maps)
    file = sum(m[1] - m[2] for m in maps
               if m[0].startswith("/") and not m[0].startswith("/dev/"))
    return {"RssAnon": anon, "RssFile": file,
            "RssShmem": sum(m[1] for m in maps) - anon - file}


def _smaps() -> Optional[List[List]]:
    try:
        with open("/proc/self/smaps") as fh:
            return parse_smaps(fh)
    except OSError:
        return None


def memory_by_path() -> None:
    """At the first call after enable(), with the recorder on: the
    resident kB of the TOP_PATHS largest mapped paths and of the rest
    ("other"), from /proc/self/smaps; None where that file is missing."""
    global _by_path, _by_path_due
    if not (_on and _by_path_due):
        return
    _by_path_due = False
    t = time.perf_counter_ns()
    maps = _smaps()
    top = None
    if maps is not None:
        kb: Dict[str, int] = {}
        for path, rss, _ in maps:
            kb[path] = kb.get(path, 0) + rss
        ranked = sorted(kb.items(), key=lambda kv: -kv[1])
        top = [list(kv) for kv in ranked[:TOP_PATHS]]
        top.append(["other", sum(v for _, v in ranked[TOP_PATHS:])])
    _by_path = {"label": "smaps", "t_ns": t, "rss_by_path_kb": top}


def memory_readings() -> List[Dict]:
    """Every kept memory reading, in the order taken."""
    with _lock:
        out = [*_mem_first.values(), *_mem_recent]
    if _by_path is not None:
        out.append(_by_path)
    return sorted(out, key=lambda r: r["t_ns"])


def snapshot() -> Dict:
    """The spans and counters so far, the id of the main thread,
    (time.time_ns(), perf_counter_ns()) at enable and now: the pair a
    reader maps Unix-time stamps (Kineto's) onto this clock with, and
    checks the mapping for drift; and the memory readings."""
    with _lock:
        spans, counts = list(_SPANS), dict(_COUNTS)
    return {"spans": spans, "counts": counts,
            "main_thread": threading.main_thread().ident,
            "clock_at_enable": _clock_at_enable,
            "clock_at_snapshot": _clock(),
            "memory": memory_readings()}


def self_times(spans) -> List[int]:
    """Each closed span's duration less the part its children cover, in
    ns (0 for a span still open)."""
    out = [0 if s[2] is None else s[2] - s[1] for s in spans]
    for s in spans:
        if s[3] >= 0 and s[2] is not None and spans[s[3]][2] is not None:
            out[s[3]] -= s[2] - s[1]
    return out


def report(file=None) -> None:
    """The ``--trace`` report: each span name's count, total and self
    seconds, the counters, each kernel's launches, the window refiner's
    tallies and the memory readings (MiB)."""
    from ..engine import kernels
    from ..engine.window_device import BAND_STATS
    file = file or sys.stderr
    snap = snapshot()
    spans = snap["spans"]
    agg: Dict[str, List] = {}
    for s, own in zip(spans, self_times(spans)):
        if s[2] is None:
            continue
        a = agg.setdefault(s[0], [0, 0, 0])
        a[0] += 1
        a[1] += s[2] - s[1]
        a[2] += own
    print("--- vapor-tpu-torch trace ---", file=file)
    for name, (n, total, own) in sorted(agg.items(),
                                        key=lambda kv: -kv[1][1]):
        print(f"span {name:14s} calls={n:7d} total={total / 1e9:9.3f}s "
              f"self={own / 1e9:9.3f}s avg={total / n / 1e6:8.3f}ms",
              file=file)
    for name, n in sorted(snap["counts"].items()):
        print(f"count {name} {n}", file=file)
    for name, n in BAND_STATS.items():
        print(f"refiner {name} {n}", file=file)
    for name in kernels.ALL_NAMES:
        print(f"kernel {name} launches={kernels.LAUNCHES[name]}",
              file=file)
    for r in snap["memory"]:
        if "rss_by_path_kb" in r:
            for path, kb in r["rss_by_path_kb"] or [["(no smaps)", 0]]:
                print(f"memory smaps {kb / 1024:10.1f} MiB {path}",
                      file=file)
            continue
        vals = " ".join(
            f"{k}=-" if r[k] is None else f"{k}={r[k] / 1024:.1f}"
            for k in (*STATUS_FIELDS, "maxrss_kb"))
        pinned = "-" if r["pinned_bytes"] is None else \
            f"{r['pinned_bytes'] / 2 ** 20:.1f}"
        print(f"memory {r['label']} t={r['t_ns'] / 1e9:.6f}s {vals} "
              f"pinned={pinned}", file=file)
