"""A route's kernels against the bound on bytes: their device time an
event, and the share of it that the route's bytes (``spans.py``'s
``bytes_by_route``) need at the card's HBM bandwidth (``peaks.json``).

Device time comes from the traced window's seconds by device op
(``run.device["by_name"]``, torch.profiler's names): an op counts for a
kernel ``<name>`` of ``vapor_tpu_torch.engine.kernels`` where its symbol
is ``<name>_kernel`` (hist's self-stats route: ``hist_self``).
"""
from __future__ import annotations

import re
from typing import Dict, Iterable, Optional

# the first identifier followed by a template's or an argument list's
# opening: "void hist_kernel<2>(...)", "(anonymous namespace)::x_kernel(...)"
_SYMBOL = re.compile(r"([A-Za-z_]\w*)[<(]")


def kernel_symbol(op: str) -> Optional[str]:
    """The function name of a device op as the profiler names it."""
    m = _SYMBOL.search(op.replace("(anonymous namespace)::", ""))
    return m.group(1) if m else None


def kernel_seconds(by_name: Dict[str, float],
                   kernels: Iterable[str]) -> float:
    """Seconds of the device ops that are launches of `kernels`."""
    want = {k + "_kernel" for k in kernels}
    return sum(s for op, s in by_name.items() if kernel_symbol(op) in want)


def share_pct(nbytes: float, seconds: float, peaks: Dict) -> Optional[float]:
    """The least time `nbytes` take at the HBM bandwidth, as a % of
    `seconds`; None where either is nought."""
    if seconds <= 0 or nbytes <= 0:
        return None
    bound_s = nbytes / peaks["hbm_bytes_per_s"]
    return 100.0 * bound_s / seconds


def route_ms_per_event(run, kernels: Iterable[str]) -> Optional[float]:
    """Device ms an event of the route's kernels; None where the traced
    window ran none of them."""
    by_name = run.device.get("by_name")
    if not by_name or not run.events:
        return None
    s = kernel_seconds(by_name, kernels)
    return 1e3 * s / run.events if s > 0 else None


def route_roofline(run, route: str, kernels: Iterable[str]) \
        -> Optional[float]:
    """The route's bytes at the HBM bound over its kernels' device time,
    in %; None where the window scored nothing on the route or ran none
    of its kernels."""
    by_name = run.device.get("by_name")
    if not by_name:
        return None
    return share_pct(run.bytes_by_route.get(route, 0),
                     kernel_seconds(by_name, kernels), run.peaks)
