"""The program's memory readings, as the per-layer readers take them.

The program takes them itself (``vapor_tpu_torch/utils/trace.py``'s
``memory``): a reading is a dict of its ``label``, ``t_ns`` on
``time.perf_counter_ns()``, the kB of ``VmRSS``, ``VmHWM``, ``RssAnon``,
``RssFile`` and ``RssShmem`` (None where the kernel does not show the
field), ``maxrss_kb``, the process's peak since its start (ru_maxrss),
and ``pinned_bytes``, what torch's caching host allocator holds (None
before CUDA is initialised).  Labels: ``import`` (the CLI module
imported), ``call.enter`` and ``call.exit`` (each ``cli.main``),
``kernel.load.<library>.enter``/``.exit`` (around a kernel library's
load) and ``kernel.first.<wrapper>.enter``/``.exit`` (around a C entry
point's first call).  The recorder keeps them across ``reset``, so the
traced window's snapshot (``run.program["memory"]``) holds set-up's
readings too; the window's are those taken from ``enable`` on
(``clock_at_enable``).  A run whose program takes no readings gives each
reader nothing to read.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

KIB_PER_MIB = 1024


def readings(run) -> Optional[List[Dict]]:
    snap = getattr(run, "program", None)
    if not snap or not snap.get("memory") or \
            snap.get("clock_at_enable") is None:
        return None
    return snap["memory"]


def before_and_in_window(run) -> Optional[Tuple[List[Dict], List[Dict]]]:
    """The readings taken before the window opened, and in it."""
    mem = readings(run)
    if mem is None:
        return None
    t0 = run.program["clock_at_enable"][1]
    return ([r for r in mem if r["t_ns"] < t0],
            [r for r in mem if r["t_ns"] >= t0])


def first(rs: List[Dict], label: str) -> Optional[Dict]:
    return next((r for r in rs if r["label"] == label), None)


def last(rs: List[Dict], label: str) -> Optional[Dict]:
    return next((r for r in reversed(rs) if r["label"] == label), None)


def mib(reading: Optional[Dict], field: str) -> Optional[float]:
    """The reading's `field` in MiB, or None."""
    if reading is None or reading.get(field) is None:
        return None
    return reading[field] / KIB_PER_MIB


def component_at_warm_exit(run, field: str) -> Optional[float]:
    """`field` in MiB at the last call.exit before the window: the
    warm-up call's exit, the state the window starts from."""
    split = before_and_in_window(run)
    if split is None:
        return None
    return mib(last(split[0], "call.exit"), field)


def growth_mib(start: Optional[Dict], end: Optional[Dict],
               start_field: str = "VmRSS",
               end_field: str = "VmRSS") -> Optional[float]:
    a, b = mib(start, start_field), mib(end, end_field)
    return None if a is None or b is None else b - a
