"""Host ms an event blocked on the card for a launch group's results
(the CUDA event behind its copy to the host): the program's
``batch.sync`` spans (benchmarks/program.py)."""
from benchmarks import program


def read(run):
    return program.ms_per_event(run, "batch.sync")
