"""Spans and counters of a traced run, recorded from the benchmark.

``Spans.install`` wraps ValidatorContext's primitives at class level (and
the fused backend's DEL dispatcher, which the DEL validator calls in
place of ``_score_async``) for the traced run only; ``remove`` puts them
back.  Each span is kept in memory as (name, start, end) on the host's
``perf_counter``:

* ``reads``    - ``ValidatorContext.reads``: read gather
* ``fetch``    - ``ValidatorContext.fetch``: haplotype bytes from the FASTA
* ``dispatch`` - inside ``_score_async`` / ``score_del_batch_async``
* ``wait``     - inside the finishers those two return

and ``bytes_by_route`` counts, for every sequence handed to the scorers
and to the window refiner, each haplotype and read byte once and one
8-byte score per (read, haplotype): the least traffic any implementation
of the scoring has to move.  Its routes are the scorer's mode (``m1b``,
``w10``, ``rdd``: the scorer handed to ``_score_async``), ``del``
(``score_del_batch_async``) and ``refiner``; their sum is the bound of
every kernel together.
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import List, Tuple


# the scorer handed to ValidatorContext._score_async -> its route
ROUTES = {"abs_dis_m1b": "m1b", "within_10perc_m1b": "w10",
          "redefine_diagonal": "rdd"}


class Spans:
    def __init__(self):
        self.intervals: List[Tuple[str, float, float]] = []
        self.totals = defaultdict(float)
        self.bytes_by_route = defaultdict(int)
        self.installed = set()
        self._saved = []

    def _add(self, name: str, t0: float, t1: float) -> None:
        self.intervals.append((name, t0, t1))
        self.totals[name] += t1 - t0

    def _count(self, route: str, ref_seq: str, alt_seq: str,
               reads) -> None:
        self.bytes_by_route[route] += len(ref_seq) + len(alt_seq) + \
            sum(len(r[0]) for r in reads) + 16 * len(reads)

    def _timed(self, name: str, fn):
        spans = self

        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spans._add(name, t0, time.perf_counter())
        return wrapper

    def _dispatcher(self, fn, seqs):
        spans = self

        def wrapper(*a, **kw):
            spans._count(*seqs(*a, **kw))
            t0 = time.perf_counter()
            fin = fn(*a, **kw)
            spans._add("dispatch", t0, time.perf_counter())

            def waited():
                t1 = time.perf_counter()
                try:
                    return fin()
                finally:
                    spans._add("wait", t1, time.perf_counter())
            return waited
        return wrapper

    def _refiner(self, fn):
        spans = self

        def wrapper(ctx, seq):
            spans.bytes_by_route["refiner"] += len(seq) + 8
            return (yield from fn(ctx, seq))
        return wrapper

    def _patch(self, owner, name, make, *spans):
        """Wraps owner.name, if the program still has it; `spans` are the
        span names the wrapper records."""
        old = owner.__dict__.get(name)
        if old is None:
            return
        self._saved.append((owner, name, old))
        setattr(owner, name, make(old))
        self.installed.update(spans)

    def install(self) -> None:
        from vapor_tpu_torch.engine.fused import FusedBackend
        from vapor_tpu_torch.validators import ValidatorContext as V
        self._patch(V, "reads", lambda f: self._timed("reads", f), "reads")
        self._patch(V, "fetch", lambda f: self._timed("fetch", f), "fetch")
        self._patch(V, "_score_async", lambda f: self._dispatcher(
            f, lambda ctx, scorer, ref, alt, reads, window:
            (ROUTES.get(scorer, scorer), ref, alt, reads)),
            "dispatch", "wait")
        self._patch(V, "_refine_gen", self._refiner)
        self._patch(FusedBackend, "score_del_batch_async",
                    lambda f: self._dispatcher(
                        f, lambda be, ref, alt, reads, window:
                        ("del", ref, alt, reads)), "dispatch", "wait")

    def span_totals(self):
        """Seconds in each installed span (0 for one that never ran)."""
        return {name: self.totals.get(name, 0.0) for name in self.installed}

    def remove(self) -> None:
        while self._saved:
            owner, name, old = self._saved.pop()
            setattr(owner, name, old)


def device_intervals(prof, offset_ns: int):
    """(name, start, end) of every device activity in the profile, on the
    host's perf_counter clock (Kineto stamps in Unix time; `offset_ns`
    is time_ns() - perf_counter_ns() at the window's start)."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type().name != "CUDA":
            continue
        start = (ev.start_ns() - offset_ns) / 1e9
        out.append((ev.name(), start, start + ev.duration_ns() / 1e9))
    out.sort(key=lambda x: x[1])
    return out


def union_length(intervals, lo: float, hi: float) -> float:
    """Seconds of [lo, hi] covered by at least one interval."""
    busy, cur_s, cur_e = 0.0, None, None
    for _, s, e in intervals:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def _overlap(a, b) -> float:
    """Seconds in both of two sorted lists of disjoint (start, end)."""
    i = j = 0
    out = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def idle_gaps(device, lo: float, hi: float):
    """Sorted (start, end) of [lo, hi] in which no device activity ran."""
    gaps, cur = [], lo
    for _, s, e in device:
        if s > cur:
            gaps.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        gaps.append((cur, hi))
    return [g for g in gaps if g[1] > g[0]]


def idle_by_span(gaps, host, calls):
    """Idle device seconds by what the host was doing: the span open
    then, "cli_self" inside a call outside every span, "between_calls"
    outside the calls.  Spans are disjoint and lie inside the calls."""
    out = {}
    inner = 0.0
    for name in sorted({h[0] for h in host}):
        out[name] = _overlap(gaps, sorted((s, e) for n, s, e in host
                                          if n == name))
        inner += out[name]
    in_calls = _overlap(gaps, sorted(calls))
    out["cli_self"] = in_calls - inner
    out["between_calls"] = sum(e - s for s, e in gaps) - in_calls
    return out

