"""Host ms an event inside ValidatorContext.reads: read gather through the
BAI, record parse, CIGAR clip and subsample."""


def read(run):
    if "reads" not in run.spans or not run.events:
        return None
    return 1e3 * run.spans["reads"] / run.events
