#!/usr/bin/env python3
"""The host side of an end-to-end vapor_tpu_torch bed run on the card,
under cProfile, and the device's busy and idle share.

The worklist is vapor_tpu_torch/sim/scale.py build_event_worklist(n)
(one contig of evenly spaced DEL/INV/DUP events, 8 donor and 8
reference reads each), or with --worklist capstone build_scale_case at
--contigs N (the capstone's widths: 400 kb contigs, 42 events each, 16
reads per event), through the default backend at --pipeline 24.  One
warm pass (kernel build, first launches), then a run under cProfile:
the top 45 entries by `sort`, then events/s and reads/s of that run;
then one run under torch.profiler, whose kernels' device time over its
wall time gives the busy and idle shares (scripts/profile_torch_bed.py
device_profile).

    python3 scripts/profile_e2e_torch.py [n_events] [sort]
        [--worklist events|capstone] [--contigs 4] [--device cuda|cpu]
        [--out chiprun_out/profile_e2e_torch.json]
"""
import argparse
import cProfile
import io
import json
import os
import pstats
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_events", nargs="?", type=int, default=24)
    ap.add_argument("sort", nargs="?", default="cumulative")
    ap.add_argument("--worklist", default="events",
                    choices=["events", "capstone"])
    ap.add_argument("--contigs", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=os.path.join(
        REPO, "chiprun_out", "profile_e2e_torch.json"))
    args = ap.parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("profile_e2e_torch: no CUDA card (--device cpu runs on the "
              "CPU)", file=sys.stderr)
        return 1
    from e2e_pipeline_bench_torch import build_worklist, reads_scored, run
    with tempfile.TemporaryDirectory(prefix="vapor_prof_e2e_") as tmp:
        fa, bam, bed, n = build_worklist(tmp, args.worklist, args.n_events,
                                         args.contigs)

        def one(tag):
            return run(tmp, fa, bam, bed, "torch", args.device, 24, tag)

        one("warm")
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        _, text, launches = prof.runcall(one, "profiled")
        wall = time.perf_counter() - t0
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats(args.sort).print_stats(45)
        print(out.getvalue())
        n_reads = reads_scored(text)
        print(f"e2e: {n_reads / wall:.1f} reads/s  {n / wall:.2f} events/s "
              f"(under cProfile, {n} events, {n_reads} reads scored, "
              f"{wall:.3f} s)", flush=True)
        report = {"worklist": args.worklist, "events": n,
                  "reads_scored": n_reads, "device": args.device,
                  "cprofile_wall_s": wall, "launches": launches}
        if args.device == "cuda":
            from profile_torch_bed import device_profile
            from vapor_tpu_torch.engine.kernels.roofline import card_line
            report.update(device_profile(lambda: one("traced")))
            report["card"] = card_line()
            print(f"device busy {report['device_busy_s']:.4f} s of "
                  f"{report['traced_wall_s']:.3f} s: idle share "
                  f"{report['device_idle_share']:.4f}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fo:
        json.dump(report, fo, indent=1)
    print(json.dumps({k: report[k] for k in (
        "worklist", "events", "device", "card", "device_idle_share")
        if k in report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
