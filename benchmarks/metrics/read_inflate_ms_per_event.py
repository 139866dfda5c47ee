"""Host ms an event in IndexedBam's block inflations inside read gather
(file read and zlib of a block its cache missed): the program's
``bam.inflate`` spans inside a ``reads`` span (benchmarks/program.py)."""
from benchmarks import program


def read(run):
    return program.ms_per_event(run, "bam.inflate", within="reads")
