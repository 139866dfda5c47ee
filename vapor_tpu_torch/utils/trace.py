"""Lightweight per-stage tracing (--trace).

The reference has no observability beyond per-event prints (SURVEY §5);
this wraps the ValidatorContext primitives with wall-clock accounting and
prints a summary at exit, with the launches of each kernel in the
process.  On the card, combine with ``torch.profiler`` for device traces
(scripts/profile_torch_bed.py).
"""
from __future__ import annotations

import atexit
import sys
import time
from collections import defaultdict

_STATS = defaultdict(lambda: [0, 0.0])


def _wrap(obj, name):
    fn = getattr(obj, name)

    def timed(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            _STATS[name][0] += 1
            _STATS[name][1] += time.perf_counter() - t0

    setattr(obj, name, timed)


def _wrap_async(obj, name):
    """Time an async dispatcher separately from its finisher wait."""
    fn = getattr(obj, name)

    def timed(*a, **kw):
        t0 = time.perf_counter()
        fin = fn(*a, **kw)
        _STATS[name][0] += 1
        _STATS[name][1] += time.perf_counter() - t0

        def waited():
            t1 = time.perf_counter()
            try:
                return fin()
            finally:
                _STATS[name + ".wait"][0] += 1
                _STATS[name + ".wait"][1] += time.perf_counter() - t1
        return waited

    setattr(obj, name, timed)


def enable_trace(ctx) -> None:
    for name in ("fetch", "reads", "refine"):
        _wrap(ctx, name)
    # the validator generators dispatch through _score_async; _score
    # routes through it too, so both pipelined and blocking runs count
    _wrap_async(ctx, "_score_async")
    atexit.register(_report)


def _report() -> None:
    from ..engine import kernels
    print("--- vapor-tpu-torch trace ---", file=sys.stderr)
    for name, (count, total) in sorted(_STATS.items(),
                                       key=lambda kv: -kv[1][1]):
        print(f"{name:10s} calls={count:6d} total={total:8.3f}s "
              f"avg={total / max(count, 1) * 1e3:8.2f}ms", file=sys.stderr)
    for name in kernels.ALL_NAMES:
        print(f"kernel {name} launches={kernels.LAUNCHES[name]}",
              file=sys.stderr)
