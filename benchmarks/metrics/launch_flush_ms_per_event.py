"""Host ms an event in the batching backend's flushes (grouping, pinned
uploads, launches), whichever finisher runs them: the program's
``batch.flush`` spans (benchmarks/program.py)."""
from benchmarks import program


def read(run):
    return program.ms_per_event(run, "batch.flush")
