"""Device time of the kernels (the six dot-plot kernels and the three
glue kernels), apart from the host work of their wrappers, at the shapes
the main path launches them at.

A wrapper call is host work (argument checks, output allocation, the
ctypes call) and device work (the C entry point's memset of the outputs
and the kernel; the wrappers fill nothing).  At the main path's small
buckets the two are of one size, so a call timed on CUDA events alone
(``call_ms``) does not say which of them a kernel loses its time to.
Here:

* ``capture`` records, during a main-path run, the arguments of the
  first call of each wrapper at each (name, route, H, R), the keys of
  ``kernels.LAUNCH_SHAPES`` (route "glue" for the glue kernels);
* ``tile_rows`` makes a batch of B rows from such a call's real rows;
* ``device_ms`` times the kernel's C entry point on the pointers its
  wrapper passes, taking turns over two batches, behind a spin kernel
  that holds the stream until the host has queued every call, so that no
  host gap falls inside the window;
* ``host_us`` times the host side of a wrapper call, ``call_ms`` a whole
  call;
* ``busy_ms`` sums the device time of a call that a window cannot hold
  (torch ops that synchronize the host), under torch.profiler.

Nothing runs at import; the timings need a CUDA card.
"""
from __future__ import annotations

import contextlib
import functools
import time
from typing import Callable, Dict, List, Sequence

import torch

from .. import kernels
from . import build

# a spin of this many card cycles (~10 ms at the H100's 1.98 GHz boost)
# holds the stream while the host queues a timed window; doubled, up to
# SPIN_TRIES times, when the host took longer
SPIN_CYCLES = 20_000_000
SPIN_TRIES = 4


def _each_tensor(args: Sequence, fn: Callable) -> tuple:
    """A wrapper's arguments with fn applied to every tensor in them (a
    tuple's too), once per distinct tensor: one given twice, as del's
    kept_tables launch gives h_d, stays one tensor."""
    done: Dict[int, torch.Tensor] = {}

    def each(a):
        if isinstance(a, torch.Tensor):
            if id(a) not in done:
                done[id(a)] = fn(a)
            return done[id(a)]
        return tuple(each(x) for x in a) if isinstance(a, tuple) else a
    return each(tuple(args))


def glue_key(name: str, args: Sequence) -> tuple:
    """The (name, "glue", H, R) key a glue wrapper's call counts under in
    kernels.LAUNCH_SHAPES, and its k (None where it takes none)."""
    if name == "row_codes":
        return (name, "glue", args[0].shape[1], args[1].shape[1]), args[3]
    h, (H, R) = (args[0][0], args[2:4]) if name == "kept_tables" \
        else (args[0], args[1:3])
    return (name, "glue", *kernels._glue_shape(h.shape[1], H, R)), None


@contextlib.contextmanager
def capture(store: Dict[tuple, tuple]):
    """Within the block, every wrapper call also records, at the first
    call of each (name, route, H, R) key, a copy of its arguments in
    `store` as key -> (args, kwargs); a later call at k = 10, the
    scoring and refiner k, replaces a first call at another k.  The
    wrappers (kernels.ROUTES, and the glue kernels') run as they do
    outside the block."""
    routes = {**kernels.ROUTES,
              **{(name, "glue"): name for name in kernels.GLUE_NAMES}}
    real = {wrapper: getattr(kernels, wrapper) for wrapper in routes.values()}

    def key_of(route, args, kwargs):
        if route[1] == "glue":
            return glue_key(route[0], args)
        return (*route, args[0].shape[2], args[1].shape[2]), args[5]

    def recording(route, wrapper, *args, **kwargs):
        key, k = key_of(route, args, kwargs)
        held = store.get(key)
        if held is None or (k == 10 and key_of(route, *held)[1] != 10):
            store[key] = (_each_tensor(args, torch.Tensor.clone),
                          dict(kwargs))
        return real[wrapper](*args, **kwargs)

    for route, wrapper in routes.items():
        setattr(kernels, wrapper, functools.partial(recording, route,
                                                    wrapper))
    try:
        yield store
    finally:
        for wrapper, fn in real.items():
            setattr(kernels, wrapper, fn)


def tile_rows(args: Sequence, B: int) -> tuple:
    """A wrapper's arguments with every per-row tensor (codes, ms, rlens,
    keep tables, intercepts) cut to B rows that cycle through the call's
    real rows: the pad rows fused_batch appends (rlen 1) are left out."""
    rlens = args[4]
    real = torch.nonzero(rlens > 1).flatten()
    if real.numel() == 0:
        real = torch.arange(rlens.shape[0], device=rlens.device)
    take = real[torch.arange(B, device=rlens.device) % real.numel()]
    return tuple(a.index_select(0, take).contiguous()
                 if isinstance(a, torch.Tensor) else a for a in args)


def hap_lens(ch: torch.Tensor, k: int) -> List[int]:
    """Each row's hap length from its (B, lanes, H) codes: the rows whose
    lane-0 word is not that of a window wholly in HAP_PAD (lane 0 packs 8
    symbols, so that word starts at the hap's end)."""
    from ..constants import HAP_PAD
    pad = kernels.pack_codes(torch.full((1, 8), HAP_PAD, dtype=torch.uint8,
                                        device=ch.device), k, HAP_PAD)[0, 0, 0]
    return [int(n) for n in (ch[:, 0] != pad).sum(1)]


def rolled(args: Sequence) -> tuple:
    """A second batch of the same rows: every per-row tensor of a
    wrapper's arguments (a tuple's too) rolled by one row, into new
    memory."""
    return _each_tensor(args, lambda t: t.roll(1, 0).contiguous())


class _Launch:
    """The launch of one wrapper call, recorded instead of made: the
    kernel's name and route and the arguments `_launch` (or
    `_launch_glue`, route "glue") got (the same pointers; the card's
    index apart).  The C entry point zeroes the outputs itself, so its
    memset is timed with the kernel."""

    def __init__(self, call: Callable):
        seen = []

        def record(name, ch, *args, route="score"):
            seen.append((name, route, ch, args))

        def record_glue(name, shape, first, *args):
            seen.append((name, "glue", first, args))

        real = kernels._launch, kernels._launch_glue
        kernels._launch, kernels._launch_glue = record, record_glue
        try:
            call()
        finally:
            kernels._launch, kernels._launch_glue = real
        if len(seen) != 1:
            raise RuntimeError(f"want one launch from the call, got "
                               f"{len(seen)}: is it a wrapper call on "
                               f"CUDA tensors?")
        self.name, self.route, ch, args = seen[0]
        self.args = (ch, *args)
        self.index = ch.get_device()
        self.pointers = [a.data_ptr() if isinstance(a, torch.Tensor)
                         else a for a in self.args]


def _window_ms(steps: Sequence[Callable], n: int) -> float:
    """ms per step of n steps (taking turns over `steps`), each queued
    behind a spin kernel: the window opens when the spin ends, by which
    time the host has queued every step, so it holds device work only.
    Raises if the host could not queue them within SPIN_TRIES spins."""
    for step in steps:                      # warm
        step()
    torch.cuda.synchronize()
    cycles = SPIN_CYCLES
    for _ in range(SPIN_TRIES):
        spun, start, stop = (torch.cuda.Event(enable_timing=True)
                             for _ in range(3))
        torch.cuda._sleep(cycles)
        spun.record()
        start.record()
        for i in range(n):
            steps[i % len(steps)]()
        stop.record()
        queued_in_time = not spun.query()
        torch.cuda.synchronize()
        if queued_in_time:
            return start.elapsed_time(stop) / n
        cycles *= 2
    raise RuntimeError(f"the host took longer to queue {n} steps than a "
                       f"spin of {cycles // 2} cycles")


def device_ms(calls: Sequence[Callable], n: int = 50) -> float:
    """ms of one call's device work for wrapper calls on CUDA tensors,
    one per input batch (at least two, so that consecutive calls read
    different memory): each call's launch is recorded once, with its
    arguments, then n steps of the C entry point (the pointers the
    wrapper passes; its memset of the outputs included) take turns over
    the batches in one window.  The batches are small beside the card's
    50 MB L2, which holds them between steps as it holds the codes the
    engine's glue has just written on the main path: L2 is warm."""
    if len(calls) < 2:
        raise ValueError("want at least two input batches")
    launches = [_Launch(call) for call in calls]
    fn = build.entry_point(launches[0].name, launches[0].route)
    index = launches[0].index
    stream = torch.cuda.current_stream(index).cuda_stream

    def step(launch):
        err = fn(*launch.pointers, index, stream)
        if err:
            raise RuntimeError(f"{launch.name} kernel launch failed: CUDA "
                               f"error {err}")

    return _window_ms([functools.partial(step, x) for x in launches], n)


def busy_ms(calls: Sequence[Callable], n: int = 10) -> float:
    """ms of one call's device work for calls that a spin window cannot
    hold (a sequence of torch ops whose host work outlasts the spin, or
    whose uploads synchronize the host, as the glue kernels' plain
    versions do): n calls, taking turns over
    `calls`, under torch.profiler, and the device time of every kernel,
    copy and fill the card ran for them (host gaps between the ops are
    not counted), over n."""
    from torch.profiler import ProfilerActivity, profile
    for call in calls:                      # warm
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            calls[i % len(calls)]()
        torch.cuda.synchronize()
    us = 0.0
    for evt in prof.key_averages():
        if evt.device_type.name == "CUDA":
            us += float(getattr(evt, "self_device_time_total",
                                getattr(evt, "self_cuda_time_total", 0.0)))
    return us / 1e3 / n


def host_us(calls: Sequence[Callable], n: int = 50) -> float:
    """Host µs of one wrapper call: n calls, taking turns over `calls`,
    timed on the host clock before the synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        calls[i % len(calls)]()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * elapsed / n


def call_ms(fn: Callable, reps: int) -> float:
    """ms of one call, host work included: CUDA events over `reps` calls
    after a warm one."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps
