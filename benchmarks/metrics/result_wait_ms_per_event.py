"""Host ms an event blocked in the score finishers that _score_async and
score_del_batch_async return; with the batching backend the first
finisher that asks for an unlaunched result also launches every pending
request."""


def read(run):
    if "wait" not in run.spans or not run.events:
        return None
    return 1e3 * run.spans["wait"] / run.events
