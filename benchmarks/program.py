"""The program's own spans and counters, as the per-layer readers take
them.

The program records them itself (``vapor_tpu_torch/utils/trace.py``):
each span is ``(name, t0_ns, t1_ns, parent_index, event_id, thread_id)``
on ``time.perf_counter_ns()``, the clock the harness stamps its calls
with and maps the Kineto trace onto.  A traced run holds the recorder's
``snapshot()`` of the window as ``run.program``, and the device's idle
seconds by the innermost main-thread span open then
(``idle_by_program_span``) as ``run.device["idle_by_program"]``.  A run
without them (a program that has no recorder, or a harness that does
not turn it on) gives each reader nothing to read.

Readers count the main thread's spans: the CLI's events run there, the
band-QC workers and the BAM prefetch thread beside it.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

from .spans import _overlap

UNATTRIBUTED = "unattributed"


def snapshot_of(run) -> Optional[Dict]:
    snap = getattr(run, "program", None)
    return snap if snap and snap.get("spans") is not None else None


def _main(snap: Dict) -> Iterator[Tuple[int, tuple]]:
    """(index, span) of the main thread's closed spans."""
    main = snap["main_thread"]
    for i, s in enumerate(snap["spans"]):
        if s[5] == main and s[2] is not None:
            yield i, s


def _within(spans, i: int, name: str) -> bool:
    p = spans[i][3]
    while p >= 0:
        if spans[p][0] == name:
            return True
        p = spans[p][3]
    return False


def span_seconds(snap: Dict, name: str, within: Optional[str] = None,
                 own: bool = False) -> float:
    """Seconds in the main thread's spans of `name` (those with an
    ancestor span `within`, where given); with `own`, less the part
    their children cover."""
    spans = snap["spans"]
    total = 0
    picked = set()
    for i, s in _main(snap):
        if s[0] == name and (within is None or _within(spans, i, within)):
            total += s[2] - s[1]
            picked.add(i)
    if own:
        for _, s in _main(snap):
            if s[3] in picked:
                total -= s[2] - s[1]
    return total / 1e9


def ms_per_event(run, name: str, within: Optional[str] = None,
                 own: bool = False) -> Optional[float]:
    snap = snapshot_of(run)
    if snap is None or not run.events:
        return None
    return 1e3 * span_seconds(snap, name, within, own) / run.events


def count_per_event(run, name: str) -> Optional[float]:
    snap = snapshot_of(run)
    if snap is None or not run.events or name not in snap["counts"]:
        return None
    return snap["counts"][name] / run.events


def _own_intervals(snap: Dict) -> Dict[str, List[Tuple[float, float]]]:
    """The main thread's time by innermost open span: each span's
    interval less its children's, in seconds, sorted by name."""
    kids: Dict[int, List[Tuple[int, int]]] = {}
    for _, s in _main(snap):
        kids.setdefault(s[3], []).append((s[1], s[2]))
    out: Dict[str, List[Tuple[float, float]]] = {}
    for i, s in _main(snap):
        cur = s[1]
        mine = out.setdefault(s[0], [])
        for c0, c1 in sorted(kids.get(i, ())):
            if c0 > cur:
                mine.append((cur / 1e9, c0 / 1e9))
            cur = max(cur, c1)
        if s[2] > cur:
            mine.append((cur / 1e9, s[2] / 1e9))
    for v in out.values():
        v.sort()
    return out


def idle_by_program_span(gaps, snap: Dict) -> Dict[str, float]:
    """Idle device seconds (`gaps`: sorted, disjoint (start, end) on
    perf_counter seconds, spans.idle_gaps) by the innermost span of the
    program's main thread open then, and under none (UNATTRIBUTED)."""
    out = {name: _overlap(gaps, iv)
           for name, iv in _own_intervals(snap).items()}
    out[UNATTRIBUTED] = sum(e - s for s, e in gaps) - sum(out.values())
    return out
