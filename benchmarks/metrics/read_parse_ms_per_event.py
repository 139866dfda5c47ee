"""Host ms an event in BAM record parse inside read gather (struct unpack,
CIGAR ops to text, nibble decode): the program's ``bam.parse`` spans
inside a ``reads`` span (benchmarks/program.py)."""
from benchmarks import program


def read(run):
    return program.ms_per_event(run, "bam.parse", within="reads")
