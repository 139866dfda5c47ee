"""VmRSS growth in MiB summed over every kernel library's load and every
C entry point's first call (the readings' kernel.load.* and
kernel.first.* pairs; benchmarks/memory.py).  None where no kernel
loaded: a run on the CPU."""
from benchmarks import memory

EDGES = ("kernel.load.", "kernel.first.")


def read(run):
    mem = memory.readings(run)
    if mem is None:
        return None
    total, pairs = 0.0, 0
    for r in mem:
        if r["label"].startswith(EDGES) and r["label"].endswith(".enter"):
            exit_label = r["label"][:-len("enter")] + "exit"
            grew = memory.growth_mib(r, memory.first(mem, exit_label))
            if grew is None:
                continue
            total += grew
            pairs += 1
    return total if pairs else None
