"""Host ms an event in the CLI's row writer: the event's genotype and
result row, appended to the output file: the program's ``emit`` spans
(benchmarks/program.py)."""
from benchmarks import program


def read(run):
    return program.ms_per_event(run, "emit")
