#!/usr/bin/env python3
"""End-to-end pipeline-depth curve of vapor_tpu_torch: events/s of the
bed CLI at --pipeline 1 against deeper pipelines, on the card.

The whole bed flow is timed: parsers, BAM gather, window refinement,
device scoring, genotyping and TSV writing.  --pipeline N keeps N events
in flight, so the batching backend can put the requests of up to N
events into one launch; at --pipeline 1 no two events share one.  Every
depth's output must equal depth 1's byte for byte.

Worklists (vapor_tpu_torch/sim/scale.py):
  events     build_event_worklist(n_events): one contig of evenly spaced
             DEL/INV/DUP events, 8 donor and 8 reference reads each;
  capstone   build_scale_case at --contigs N: N contigs x 400 kb, 42
             events each (DEL, INV, tandem DUP of 150-700 bp and 2 false
             calls), 16 reads per event, seed 77 (the capstone's widths).

One untimed run at depth 8 comes first (kernel build, first launches).
The JAX package's script then warms its compile ladder for every bucket
(warm_ladder); the port builds each kernel once, at first use, so there
is no ladder to warm.

    python3 scripts/e2e_pipeline_bench_torch.py [--events 24]
        [--worklist events|capstone] [--contigs 24] [--backend torch]
        [--depths 4,8,16,24] [--device cuda|cpu]
        [--out chiprun_out/e2e_pipeline_bench_torch.json]
"""
import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def build_worklist(tmpdir, worklist="events", n_events=24, contigs=24):
    """(fasta, bam, bed, number of events) of the named worklist."""
    from vapor_tpu_torch.sim.scale import (build_event_worklist,
                                           build_scale_case)
    if worklist == "events":
        return (*build_event_worklist(tmpdir, n_events), n_events)
    case = build_scale_case(tmpdir, n_contigs=contigs, contig_len=400000,
                            events_per=42, reads_per=16)
    return case["fasta"], case["bam"], case["bed"], case["n_events"]


def reads_scored(text):
    """Per-read scores in the VaPoR_Rec column of a bed output."""
    n = 0
    for line in text.splitlines():
        if line and not line.startswith("#"):
            rec = line.split("\t")[-1]
            if rec not in ("NA", ""):
                n += len(rec.split(","))
    return n


def run(tmpdir, fa, bam, bed, backend, device, depth, tag):
    """One bed CLI run at --pipeline depth; (seconds, output text,
    kernel launches).  Counts are set to 0 just before the run and read
    just after it (after a device sync)."""
    import torch
    from vapor_tpu_torch.cli import main
    from vapor_tpu_torch.engine import kernels
    out = os.path.join(tmpdir, f"out_{tag}.vapor")
    kernels.reset_counts()
    t0 = time.perf_counter()
    with open(os.devnull, "w") as devnull, \
            contextlib.redirect_stdout(devnull):
        rc = main(["bed", "--sv-input", bed, "--reference", fa,
                   "--pacbio-input", bam, "--output-path",
                   os.path.join(tmpdir, "figs"), "--output-file", out,
                   "--backend", backend, "--device", device,
                   "--no-figures", "--pipeline", str(depth)])
    if device == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"bed CLI exited {rc} at --pipeline {depth}")
    with open(out) as fh:
        return dt, fh.read(), dict(kernels.LAUNCHES)


def bench(tmpdir, fa, bam, bed, n_events, backend, device, depths,
          log=print):
    """The warm run, then depth 1 and each of depths; returns the report.
    Raises when a depth's output differs from depth 1's."""
    run(tmpdir, fa, bam, bed, backend, device, 8, "warm")
    base_dt, base_out, launches = run(tmpdir, fa, bam, bed, backend,
                                      device, 1, "p1")
    n_reads = reads_scored(base_out)
    points = {"1": {"s": base_dt, "events_per_s": n_events / base_dt,
                    "reads_per_s": n_reads / base_dt, "speedup": 1.0,
                    "launches": launches}}
    log(f"pipeline=1  {n_events / base_dt:8.2f} events/s "
        f"({base_dt:7.3f} s) launches {launches}")
    for depth in depths:
        dt, out, launches = run(tmpdir, fa, bam, bed, backend, device,
                                depth, f"p{depth}")
        if out != base_out:
            raise RuntimeError(f"--pipeline {depth} output differs from "
                               f"--pipeline 1")
        points[str(depth)] = {"s": dt, "events_per_s": n_events / dt,
                              "reads_per_s": n_reads / dt,
                              "speedup": base_dt / dt,
                              "launches": launches}
        log(f"pipeline={depth:<2} {n_events / dt:8.2f} events/s "
            f"({dt:7.3f} s, {base_dt / dt:4.2f}x) [identical] launches "
            f"{launches}")
    return {"events": n_events, "reads_scored": n_reads,
            "backend": backend, "device": device, "points": points,
            "identical": True}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--events", type=int, default=24,
                    help="events of the 'events' worklist")
    ap.add_argument("--worklist", default="events",
                    choices=["events", "capstone"])
    ap.add_argument("--contigs", type=int, default=24,
                    help="contigs of the 'capstone' worklist")
    ap.add_argument("--backend", default="torch",
                    choices=["torch", "torch-nobatch", "numpy"])
    ap.add_argument("--depths", default="4,8,16,24")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=os.path.join(
        REPO, "chiprun_out", "e2e_pipeline_bench_torch.json"))
    args = ap.parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("e2e_pipeline_bench_torch: no CUDA card (--device cpu runs "
              "on the CPU)", file=sys.stderr)
        return 1
    depths = [int(x) for x in args.depths.split(",")]
    with tempfile.TemporaryDirectory(prefix="vapor_e2e_") as tmp:
        t0 = time.perf_counter()
        fa, bam, bed, n = build_worklist(tmp, args.worklist, args.events,
                                         args.contigs)
        print(f"{args.worklist} worklist: {n} events, built in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        report = bench(tmp, fa, bam, bed, n, args.backend, args.device,
                       depths, log=lambda s: print(s, flush=True))
    report["worklist"] = args.worklist
    if args.device == "cuda":
        from vapor_tpu_torch.engine.kernels.roofline import card_line
        report["card"] = card_line()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fo:
        json.dump(report, fo, indent=1)
    print(json.dumps({k: report[k] for k in (
        "worklist", "events", "backend", "device", "card")
        if k in report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
