"""Host ms an event inside ValidatorContext.fetch: haplotype bytes from the
FASTA."""


def read(run):
    if "fetch" not in run.spans or not run.events:
        return None
    return 1e3 * run.spans["fetch"] / run.events
