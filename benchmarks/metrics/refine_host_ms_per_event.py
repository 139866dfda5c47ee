"""Host ms an event in the device window refiner's host stretches between
its yields, the host refiner's fallback included: the program's
``refine`` spans (benchmarks/program.py)."""
from benchmarks import program


def read(run):
    return program.ms_per_event(run, "refine")
