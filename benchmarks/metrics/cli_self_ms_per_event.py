"""Host ms an event inside the CLI calls outside every span: the CLI,
the pipeline, the window refiner's host side, the genotyper and the
writers."""

SPANS = ("reads", "fetch", "dispatch", "wait")


def read(run):
    if not all(s in run.spans for s in SPANS) or not run.events:
        return None
    wall = sum(c.t1 - c.t0 for c in run.calls)
    return 1e3 * (wall - sum(run.spans[s] for s in SPANS)) / run.events
