"""Host ms an event in read gather outside its parts: the program's
``reads`` spans less their children (inflate, parse, overlap, clip),
i.e. index lookup, chunk buffering and subsample
(benchmarks/program.py)."""
from benchmarks import program


def read(run):
    return program.ms_per_event(run, "reads", own=True)
