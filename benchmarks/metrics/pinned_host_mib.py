"""MiB torch's caching host allocator holds (pinned buffers in use and
cached) at the window's last call.exit (benchmarks/memory.py).  None on
the CPU."""
from benchmarks import memory


def read(run):
    split = memory.before_and_in_window(run)
    if split is None:
        return None
    r = memory.last(split[1], "call.exit")
    if r is None or r["pinned_bytes"] is None:
        return None
    return r["pinned_bytes"] / 2 ** 20
