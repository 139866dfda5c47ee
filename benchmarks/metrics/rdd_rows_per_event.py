"""(read, haplotype) rows an event launched on the rdd route (tandem DUP
through redefine_diagonal): the program's ``score.rows.rdd`` counter
(benchmarks/program.py)."""
from benchmarks import program


def read(run):
    return program.count_per_event(run, "score.rows.rdd")
