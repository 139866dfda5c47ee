"""Host ms an event in the tandem-DUP validator, each stretch of it
between its yields, read gather, haplotype fetch, refiner and dispatch
included: the program's ``validate.dup`` spans (benchmarks/program.py).
None where the program recorded none."""
from benchmarks import program


def read(run):
    snap = program.snapshot_of(run)
    if snap is None or not any(s[0] == "validate.dup"
                               for s in snap["spans"]):
        return None
    return program.ms_per_event(run, "validate.dup")
