"""Seconds of the warm-up call, from its call.enter to its call.exit:
kernel libraries loaded, first launches, inputs opened
(benchmarks/memory.py)."""
from benchmarks import memory


def read(run):
    split = memory.before_and_in_window(run)
    if split is None:
        return None
    before = split[0]
    end = memory.last(before, "call.exit")
    if end is None:
        return None
    start = memory.last([r for r in before if r["t_ns"] <= end["t_ns"]],
                        "call.enter")
    if start is None:
        return None
    return (end["t_ns"] - start["t_ns"]) / 1e9
