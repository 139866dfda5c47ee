"""Host ms an event inside ValidatorContext._score_async and the fused
backend's score_del_batch_async: the requests handed to the batching
backend."""


def read(run):
    if "dispatch" not in run.spans or not run.events:
        return None
    return 1e3 * run.spans["dispatch"] / run.events
