"""VmRSS in MiB at the process's first CLI call less at the CLI's
import: the CUDA context and torch's CUDA state made in between, with
the kernels' build check (benchmarks/memory.py)."""
from benchmarks import memory


def read(run):
    mem = memory.readings(run)
    if mem is None:
        return None
    return memory.growth_mib(memory.first(mem, "import"),
                             memory.first(mem, "call.enter"))
