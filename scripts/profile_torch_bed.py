#!/usr/bin/env python3
"""Where the time of a vapor_tpu_torch bed run goes, on the card.

Builds chip_smoke.py's synthetic bed worklist (same seed, 34 events:
DEL, INV and tandem DUP), runs the bed CLI once to warm up (kernel
build, first launches), then, through the default backend (cross-event
batching and the device window refiner; --backend torch-nobatch for the
unbatched one):

1. a run with no instrumentation: wall time, events/s, kernel launches,
   the window refiner's tallies (BAND_STATS) and its self-stats
   launches;
2. a run under torch.profiler (CPU + CUDA activities): the device time
   of every kernel by name, summed, against the run's wall time, which
   gives the device's busy and idle shares;
3. a run under cProfile: the host time of the pipeline's stages (read
   gather, window refiner, haplotype fetch, request submission, the
   launches, waits for the card, output).  Under Python 3.12 cProfile
   also records the band-QC pool's threads (its events are process-wide),
   but calls of two threads interleave on one stack, so their times
   there are rough;
4. a run with wall-clock timers around the stages, summed by thread
   (main and the band-QC pool), without the profiler's overhead;
5. the read-gather split: a run with a fresh BAM reader (no inflated
   block cached from the runs before) and wall-clock timers around
   collect_event_reads and, inside it, BGZF inflate
   (IndexedBam._inflate_at), record parse (_parse_record) and
   clip_read_to_window; the rest of collect_event_reads is the chunk
   scan's own Python (buffer joins, offsets) and subsampling.  The
   timers wrap the functions here, not in the package.

Prints one JSON object.

    python3 scripts/profile_torch_bed.py [--seed N] [--backend B]
"""
from __future__ import annotations

import argparse
import cProfile
import functools
import json
import os
import pstats
import re
import sys
import tempfile
import threading
import time
from collections import Counter
from concurrent.futures import Future

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# cProfile stages: (label, file path suffix, function name)
STAGES = [
    ("read gather", "vapor_tpu_torch/io/reads.py", "collect_event_reads"),
    ("window refiner, device (refine_gen)",
     "vapor_tpu_torch/engine/window_device.py", "refine_gen"),
    ("window refiner, band QC (pool threads)",
     "vapor_tpu_torch/engine/window_device.py", "_band_qc"),
    ("window refiner, host (unbucketable or out-of-alphabet haps)",
     "vapor_tpu_torch/engine/window.py", "window_size_refine"),
    ("haplotype fetch", "vapor_tpu_torch/validators.py", "fetch"),
    ("request submit", "vapor_tpu_torch/engine/batching.py", "_submit"),
    ("encode + launch", "vapor_tpu_torch/engine/batching.py", "_launch"),
    ("encode + launch, unbatched", "vapor_tpu_torch/engine/fused.py",
     "_submit"),
    ("wait for the card", "torch/cuda/streams.py", "synchronize"),
    ("rows to host, unbatched (waits for the card)",
     "vapor_tpu_torch/engine/fused.py", "__init__"),
    ("wait for the band QC", "concurrent/futures/_base.py", "result"),
    ("output rows", "vapor_tpu_torch/writers/tsv.py", "append_result_row"),
]


def _thread_role(name: str) -> str:
    return re.sub(r"_\d+$", "", name)


def _timers(stages=None):
    """Wraps the stages' functions with wall-clock timers summed by
    (stage, thread); returns (totals, calls, restore).  `stages`, a list
    of (owner, attribute, label), replaces the default stages."""
    import torch
    from vapor_tpu_torch import validators
    from vapor_tpu_torch.engine import batching, fused, window_device
    totals, calls = Counter(), Counter()
    undo = []

    def wrap(owner, attr, label):
        fn = getattr(owner, attr)

        @functools.wraps(fn)
        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                key = (label, _thread_role(threading.current_thread().name))
                totals[key] += time.perf_counter() - t0
                calls[key] += 1
        setattr(owner, attr, timed)
        undo.append((owner, attr, fn))

    def restore():
        for owner, attr, fn in undo:
            setattr(owner, attr, fn)

    if stages is not None:
        for stage in stages:
            wrap(*stage)
        return totals, calls, restore
    wrap(validators, "collect_event_reads", "read gather")
    wrap(window_device.DeviceWindowRefiner, "_stats_async",
         "window refiner, device step submit")
    wrap(window_device, "_band_qc", "window refiner, band QC")
    wrap(window_device, "_host_refine", "window refiner, host")
    wrap(batching.BatchingBackend, "_submit", "request submit")
    wrap(batching.BatchingBackend, "_launch", "encode + launch")
    wrap(fused.FusedBackend, "_submit", "encode + launch, unbatched")
    wrap(torch.cuda.Event, "synchronize", "wait for the card")
    wrap(fused.FusedStats, "__init__",
         "rows to host, unbatched (waits for the card)")
    wrap(Future, "result", "wait for the band QC")
    return totals, calls, restore


def _gather_stages():
    """(owner, attribute, label) of collect_event_reads and its parts,
    for _timers."""
    from vapor_tpu_torch import validators
    from vapor_tpu_torch.io import bai, reads
    return [(validators, "collect_event_reads", "read gather"),
            (bai.IndexedBam, "_inflate_at", "inflate"),
            (bai, "_parse_record", "record parse"),
            (reads, "clip_read_to_window", "clip_read_to_window")]


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def device_profile(fn, top: int = 12, labels=()) -> dict:
    """Runs fn() once under torch.profiler (CPU + CUDA activities) and
    sums the device time of every kernel by name: the run's wall time,
    the device's busy seconds and idle share of the wall, the six
    kernels' seconds, the three glue kernels' ("glue_kernels_s"), the
    rest (torch ops, "torch_ops_s"), and the `top` kernels by device
    time.  Each of
    `labels`, a torch.profiler.record_function range that fn opens,
    gets the device seconds of the kernels launched inside it
    ("labelled_s": a label that fn never opened is left out, and one
    whose kernels this torch version's profiler does not attribute to
    it gets None)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from vapor_tpu_torch.engine import kernels
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kernel, labelled = {}, {}
    for evt in prof.key_averages():
        us = _device_us(evt)
        if evt.key in labels:
            # the range's CPU entry holds its kernels' device time (a
            # CUDA entry of the same name spans the range on the card)
            if evt.device_type.name == "CPU":
                us = float(getattr(evt, "device_time_total",
                                   getattr(evt, "cuda_time_total", 0.0)))
                labelled[evt.key] = us / 1e6 if us > 0 else None
        elif us > 0 and evt.device_type.name == "CUDA":
            by_kernel[evt.key] = by_kernel.get(evt.key, 0.0) + us
    device_s = sum(by_kernel.values()) / 1e6
    ours = {n: sum(us for key, us in by_kernel.items()
                   if re.search(rf"(?<![A-Za-z_]){n}_kernel", key)) / 1e6
            for n in kernels.ALL_NAMES}
    ranked = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:top]
    out = {"traced_wall_s": wall, "device_busy_s": device_s,
           "device_idle_share": 1 - device_s / wall,
           "our_kernels_s": {n: ours[n] for n in kernels.NAMES},
           "glue_kernels_s": {n: ours[n] for n in kernels.GLUE_NAMES},
           "torch_ops_s": device_s - sum(ours.values()),
           "top_device_kernels_s": {k: v / 1e6 for k, v in ranked}}
    if labels:
        out["labelled_s"] = labelled
        out["device_kernels_s"] = {k: v / 1e6 for k, v in by_kernel.items()}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--backend", default="torch",
                    choices=["torch", "torch-nobatch"])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_bed: no CUDA card", file=sys.stderr)
        return 1
    from vapor_tpu_torch.cli import main as cli
    from vapor_tpu_torch.engine import kernels, window_device
    from vapor_tpu_torch.engine.kernels.roofline import card_line
    from vapor_tpu_torch.sim.worklists import build_event_worklist

    with tempfile.TemporaryDirectory() as tmp:
        fa, bam, bed, events = build_event_worklist(tmp, args.seed)

        def run(tag):
            rc = cli(["bed", "--sv-input", bed, "--reference", fa,
                      "--pacbio-input", bam, "--output-path",
                      os.path.join(tmp, "figs"), "--output-file",
                      os.path.join(tmp, f"{tag}.vapor"), "--no-figures",
                      "--backend", args.backend])
            torch.cuda.synchronize()
            if rc:
                raise RuntimeError(f"bed run exited {rc}")

        run("warm")
        kernels.reset_counts()
        band0 = dict(window_device.BAND_STATS)
        t0 = time.perf_counter()
        run("plain")
        wall_plain = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        band = {x: window_device.BAND_STATS[x] - band0[x] for x in band0}
        refiner_launches = {H: n for (_, route, H, _), n
                            in sorted(kernels.LAUNCH_SHAPES.items())
                            if route == "selfstats"}

        traced = device_profile(lambda: run("traced"))

        prof_host = cProfile.Profile()
        t0 = time.perf_counter()
        prof_host.runcall(run, "host")
        wall_host = time.perf_counter() - t0
        stats = pstats.Stats(prof_host).stats
        stages = {}
        for label, path, func in STAGES:
            stages[label] = sum(
                row[3] for (file, _, name), row in stats.items()
                if name == func and file.endswith(path))

        totals, calls, restore = _timers()
        try:
            t0 = time.perf_counter()
            run("timed")
            wall_timed = time.perf_counter() - t0
        finally:
            restore()

        from vapor_tpu_torch.io.reads import _open_bam
        _open_bam.cache_clear()
        g_totals, g_calls, restore = _timers(_gather_stages())
        try:
            t0 = time.perf_counter()
            run("gather")
            wall_gather = time.perf_counter() - t0
        finally:
            restore()
        split = {f"{label} [{role}]": {"s": t,
                                       "calls": g_calls[label, role]}
                 for (label, role), t in sorted(g_totals.items())}
        # the parts on the threads that gather reads (the reader's first
        # inflate may run on the context's warm-up thread)
        roles = {role for label, role in g_totals if label == "read gather"}
        split["rest of read gather"] = {"s": sum(
            t * (1 if label == "read gather" else -1)
            for (label, role), t in g_totals.items() if role in roles)}

    out = {
        "backend": args.backend,
        "card": torch.cuda.get_device_name(0),
        "card_name_power_limit": card_line(),
        "events": len(events),
        "wall_s": wall_plain,
        "events_per_s": len(events) / wall_plain,
        "launches": launches,
        "band_stats": band,
        "self_stats_launches_by_H": refiner_launches,
        **traced,
        "cprofile_wall_s": wall_host,
        "host_stage_cumulative_s": stages,
        "timed_wall_s": wall_timed,
        "stage_wall_s_by_thread": {
            f"{label} [{role}]": {"s": t, "calls": calls[label, role]}
            for (label, role), t in sorted(totals.items())},
        "gather_split_wall_s": wall_gather,
        "read_gather_split_s": split,
    }
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
