#!/usr/bin/env python3
"""Where the time of a vapor_tpu_torch bed run goes, on the card.

Builds chip_smoke.py's synthetic DEL/INV worklist (same seed, 26 events),
runs the bed CLI once to warm up (kernel build, first launches), then:

1. a run under torch.profiler (CPU + CUDA activities): the device time
   of every kernel by name, summed, against the run's wall time, which
   gives the device's busy and idle shares;
2. a run under cProfile: the host time of the pipeline's stages
   (read gather, window refiner, haplotype fetch, encoding and launch,
   waits for results, the oracle, output).

Prints one JSON object.

    python3 scripts/profile_torch_bed.py [--seed N]
"""
from __future__ import annotations

import argparse
import cProfile
import json
import os
import pstats
import re
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# host stages: (label, module file suffix, function name)
STAGES = [
    ("read gather", "io/reads.py", "collect_event_reads"),
    ("window refiner", "engine/window.py", "window_size_refine"),
    ("haplotype fetch", "validators.py", "fetch"),
    ("encode + launch", "engine/fused.py", "_submit"),
    ("rows to host (waits for the card)", "engine/fused.py", "__init__"),
    ("output rows", "writers/tsv.py", "append_result_row"),
]


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_bed: no CUDA card", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile
    from vapor_tpu_torch.cli import main as cli
    from vapor_tpu_torch.engine import kernels
    from vapor_tpu_torch.sim.scale import build_event_worklist

    with tempfile.TemporaryDirectory() as tmp:
        fa, bam, bed, events = build_event_worklist(tmp, args.seed)

        def run(tag):
            rc = cli(["bed", "--sv-input", bed, "--reference", fa,
                      "--pacbio-input", bam, "--output-path",
                      os.path.join(tmp, "figs"), "--output-file",
                      os.path.join(tmp, f"{tag}.vapor"), "--no-figures"])
            torch.cuda.synchronize()
            if rc:
                raise RuntimeError(f"bed run exited {rc}")

        run("warm")
        kernels.reset_counts()
        t0 = time.perf_counter()
        run("plain")
        wall_plain = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run("traced")
            wall_traced = time.perf_counter() - t0
        by_kernel = {}
        for evt in prof.key_averages():
            us = _device_us(evt)
            if us > 0 and evt.device_type.name == "CUDA":
                by_kernel[evt.key] = by_kernel.get(evt.key, 0.0) + us
        device_s = sum(by_kernel.values()) / 1e6
        ours = {n: sum(us for key, us in by_kernel.items()
                       if re.search(rf"(?<![A-Za-z_]){n}_kernel", key)) / 1e6
                for n in kernels.NAMES}
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]

        prof_host = cProfile.Profile()
        t0 = time.perf_counter()
        prof_host.runcall(run, "host")
        wall_host = time.perf_counter() - t0
        stats = pstats.Stats(prof_host).stats
        stages = {}
        for label, path, func in STAGES:
            stages[label] = sum(
                row[3] for (file, _, name), row in stats.items()
                if name == func and file.endswith(
                    os.path.join("vapor_tpu_torch", path)))

    out = {
        "card": torch.cuda.get_device_name(0),
        "events": len(events),
        "wall_s": wall_plain,
        "events_per_s": len(events) / wall_plain,
        "launches": launches,
        "traced_wall_s": wall_traced,
        "device_busy_s": device_s,
        "device_idle_share": 1 - device_s / wall_traced,
        "our_kernels_s": ours,
        "top_device_kernels_s": {k: v / 1e6 for k, v in top},
        "cprofile_wall_s": wall_host,
        "host_stage_cumulative_s": stages,
    }
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
