"""4-panel recurrence-plot figures (make_event_figure_1, pyx:1041-1089).

Panels: ref x ref, alt x alt, best-read x ref, best-read x alt; red '+'
markers and the reference's magnitude-dependent tick ladder.  Dot
coordinates are recomputed on host for the single best read only — the
device kernels never ship dot clouds back.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from .engine import oracle  # noqa: E402

import threading  # noqa: E402

_FIG_LOCK = threading.Lock()  # matplotlib pyplot state is not thread-safe


def _tick_ladder(max_x: int) -> List[int]:
    """The reference's xtick scheme (pyx:1052-1063)."""
    mag = 10 ** (len(str(max_x)) - 1)
    span = int(float(max_x) / float(mag)) + 1
    if span < 3:
        ticks = [(i + 1) * mag for i in range(span)]
        halves = [ticks[0] // 2]
        for i in range(len(ticks) - 1):
            halves.append(halves[0] * (2 * (i + 1) + 1))
        ticks = sorted(ticks + halves)
    elif span < 5:
        ticks = [(i + 1) * mag for i in range(span)]
    else:
        ticks = [(i + 1) * 2 * mag for i in range(span // 2 + 2)]
    return ticks


def _subplot(dots: Sequence[Tuple[int, int]], title: str,
             position: int) -> None:
    if len(dots) == 0:
        return
    xs = [d[0] for d in dots]
    ys = [d[1] for d in dots]
    plt.subplot(position)
    plt.plot(xs, ys, "+", color="r")
    ticks = _tick_ladder(max(xs))
    plt.xticks(ticks, [str(t) for t in ticks])
    plt.title(title)
    plt.grid(False)


def make_event_figure(best_read: Sequence, window: int, ref_seq: str,
                      alt_seq: str, out_name: str) -> None:
    if best_read == "" or best_read == []:
        return
    panels = [
        oracle.dotdata(window, ref_seq, ref_seq),
        oracle.dotdata(window, alt_seq, alt_seq),
        oracle.dotdata(window, best_read[0], ref_seq[best_read[1]:]),
        oracle.dotdata(window, best_read[0], alt_seq[best_read[1]:]),
    ]
    if any(len(p) == 0 for p in panels):
        return
    # clamp over-long figure names (pyx:1080-1081)
    base = out_name.split("/")[-1]
    if len(base) > 150:
        out_name = "/".join(out_name.split("/")[:-1]) + "/" + \
            base[:140] + "." + out_name.split(".")[-1]
    with _FIG_LOCK:
        fig = plt.figure()
        _subplot(panels[0], "ref vs. ref", 221)
        _subplot(panels[1], "alt vs. alt", 222)
        _subplot(panels[2], "read vs. ref", 223)
        _subplot(panels[3], "read vs. alt", 224)
        plt.savefig(out_name)
        plt.close(fig)
