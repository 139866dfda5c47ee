"""BAM records an event that the index scans settle from the fixed header
alone (they end the scan or miss the window), decoding no name or bases:
the program's ``bam.records_header_only`` counter
(benchmarks/program.py)."""
from benchmarks import program


def read(run):
    return program.count_per_event(run, "bam.records_header_only")
