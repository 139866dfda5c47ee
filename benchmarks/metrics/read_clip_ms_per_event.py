"""Host ms an event in clipping reads to the window inside read gather
(the CIGAR walk to the window's start): the program's ``reads.clip``
spans inside a ``reads`` span (benchmarks/program.py)."""
from benchmarks import program


def read(run):
    return program.ms_per_event(run, "reads.clip", within="reads")
