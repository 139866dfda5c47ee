"""Reads an event that the host's numpy oracle scored in place of the
card (a haplotype or read past the largest bucket, a byte outside the
engine alphabet, a scorer with no device mode): the program's
``score.host_reads`` counter (benchmarks/program.py).  0.0 where the
program counted the rows it scored on the card (``score.rows.<route>``)
and this counter never fired; None for a program that counts neither."""
from benchmarks import program


def read(run):
    snap = program.snapshot_of(run)
    if snap is None or not run.events or not any(
            k.startswith("score.rows.") for k in snap["counts"]):
        return None
    return snap["counts"].get("score.host_reads", 0) / run.events
