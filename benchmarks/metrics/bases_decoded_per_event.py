"""Read bases an event decoded from BAM's nibbles, the clipped slices
that the scorers get: the program's ``reads.bases_decoded`` counter
(benchmarks/program.py)."""
from benchmarks import program


def read(run):
    return program.count_per_event(run, "reads.bases_decoded")
