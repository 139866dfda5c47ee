"""Host ms an event in the index scan's overlap test inside read gather
(a record's end from its CIGAR text): the program's ``bam.overlap``
spans inside a ``reads`` span (benchmarks/program.py)."""
from benchmarks import program


def read(run):
    return program.ms_per_event(run, "bam.overlap", within="reads")
