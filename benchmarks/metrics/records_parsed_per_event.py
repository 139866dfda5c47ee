"""BAM records parsed an event by the index scans of read gather: the
program's ``bam.records_parsed`` counter (benchmarks/program.py)."""
from benchmarks import program


def read(run):
    return program.count_per_event(run, "bam.records_parsed")
