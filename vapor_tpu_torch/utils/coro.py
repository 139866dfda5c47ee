"""Cooperative pipelining primitives for the validator coroutines.

Validators are written once, as generators that *yield zero-arg
finishers* wherever a device round-trip would block (window refinement
stats, score batches).  Two drivers consume them:

* ``drain`` — resolve each finisher immediately: exactly the original
  blocking control flow (the public ``validate_*`` methods).
* ``run_pipelined`` — keep up to N task generators in flight on one
  thread.  Younger generators' device work is already launched while
  the oldest generator's finisher blocks, so the device does not idle
  while one result comes back.  With the batching backend, the pending
  requests of the in-flight events also coalesce into combined launches.
  Results are emitted strictly in submission order.

A finisher is any zero-argument callable: a closure over a batching
future, or the bound ``Future.result`` of the window refiner's band-QC
worker pool, which blocks until that worker is done.
"""
from __future__ import annotations

from typing import Callable, Iterable, List


def drain(gen):
    """Run a finisher-yielding generator to completion, resolving each
    yielded finisher immediately (the sequential/blocking semantics)."""
    try:
        fin = next(gen)
        while True:
            fin = gen.send(fin())
    except StopIteration as stop:
        return stop.value


def run_pipelined(tasks: Iterable[Callable], emit: Callable,
                  depth: int) -> None:
    """Run task-generator factories, overlapping up to ``depth`` of
    them; ``emit(*result)`` fires in submission order.

    Each factory returns a generator yielding zero-arg finishers and
    returning the emit arguments.  The scheduler advances the in-flight
    tasks breadth-first (oldest first in each round): every task takes
    one step — resolve its pending finisher, run to its next dispatch —
    before any task takes a second step.  That way all in-flight
    events' device launches are issued before the scheduler blocks on
    the next round of results (depth-first advancement would serialize
    one launch and one wait per event).
    """
    results = {}
    next_emit = 0

    def flush():
        nonlocal next_emit
        while next_emit in results:
            emit(*results.pop(next_emit))
            next_emit += 1

    if depth <= 1:
        for i, factory in enumerate(tasks):
            results[i] = drain(factory())
            flush()
        return

    it = enumerate(iter(tasks))
    exhausted = False
    active: List = []     # [index, generator, pending finisher]

    def admit():
        nonlocal exhausted
        while not exhausted and len(active) < depth:
            nxt = next(it, None)
            if nxt is None:
                exhausted = True
                return
            i, factory = nxt
            gen = factory()
            try:
                active.append([i, gen, next(gen)])
            except StopIteration as stop:
                results[i] = stop.value
                flush()

    admit()
    while active:
        idx = 0
        while idx < len(active):
            i, gen, fin = active[idx]
            try:
                active[idx][2] = gen.send(fin())
                idx += 1
            except StopIteration as stop:
                active.pop(idx)
                results[i] = stop.value
                flush()
                admit()
