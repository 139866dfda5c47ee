"""BGZF blocks inflated an event by read gather (IndexedBam's block
cache misses): the program's ``bam.blocks_inflated`` counter
(benchmarks/program.py)."""
from benchmarks import program


def read(run):
    return program.count_per_event(run, "bam.blocks_inflated")
