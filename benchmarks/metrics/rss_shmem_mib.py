"""RssShmem in MiB at the warm-up call's exit, the state the window
starts from: the program's memory readings (benchmarks/memory.py)."""
from benchmarks import memory


def read(run):
    return memory.component_at_warm_exit(run, "RssShmem")
