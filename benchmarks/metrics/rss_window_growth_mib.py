"""The window's peak in MiB at its last call.exit less VmRSS at its
first call.enter: how far the peak stands above where the window
started.  The peak is VmHWM, reset when the window opens, or where the
kernel keeps no VmHWM the process's ru_maxrss since its start, as the
harness's peak_host_rss_mib reads it: set-up's peak is then in it too
(benchmarks/memory.py)."""
from benchmarks import memory


def read(run):
    split = memory.before_and_in_window(run)
    if split is None:
        return None
    window = split[1]
    end = memory.last(window, "call.exit")
    field = "VmHWM" if end is None or end["VmHWM"] is not None \
        else "maxrss_kb"
    return memory.growth_mib(memory.first(window, "call.enter"), end,
                             end_field=field)
