"""Share of the events whose score came from a junction window (a DEL,
INV or tandem DUP spanning 10 kb or more, or the INV and DUP junction
fallbacks): the program's ``validate.junction`` counter over the events
(benchmarks/program.py).  0.0 where the program stepped its validators
under their spans (``validate.*``) and this counter never fired; None
for a program that has neither."""
from benchmarks import program


def read(run):
    snap = program.snapshot_of(run)
    if snap is None or not run.events or not any(
            s[0].startswith("validate.") for s in snap["spans"]):
        return None
    return snap["counts"].get("validate.junction", 0) / run.events
