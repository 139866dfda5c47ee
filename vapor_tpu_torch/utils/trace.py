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
"""
from __future__ import annotations

import functools
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
    global _on, _clock_at_enable
    _clock_at_enable = _clock()
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


def snapshot() -> Dict:
    """The spans and counters so far, the id of the main thread, and
    (time.time_ns(), perf_counter_ns()) at enable and now: the pair a
    reader maps Unix-time stamps (Kineto's) onto this clock with, and
    checks the mapping for drift."""
    with _lock:
        spans, counts = list(_SPANS), dict(_COUNTS)
    return {"spans": spans, "counts": counts,
            "main_thread": threading.main_thread().ident,
            "clock_at_enable": _clock_at_enable,
            "clock_at_snapshot": _clock()}


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
    seconds, the counters, each kernel's launches and the window
    refiner's tallies."""
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
