#!/usr/bin/env python3
"""Scale throughput run of vapor_tpu_torch on the card: an HG002-shaped
simulated worklist through the full CLI (validators, BAM gather,
genotyping, writers), in one process with the batching backend or in
per-contig scatter processes.

  SCALE_CONTIGS=6 SCALE_LEN=200000 SCALE_EVENTS=40 SCALE_MODE=pipeline \\
      python3 scripts/scale_run_torch.py

Knobs (environment): SCALE_CONTIGS (4), SCALE_LEN (150000), SCALE_EVENTS
(24 per contig), SCALE_MODE (pipeline or scatter), SCALE_BACKEND
(torch), SCALE_PIPELINE (8), SCALE_JOBS (scatter processes at a time, 1)
and SCALE_DEVICE (cuda; --device overrides it).  The worklist is
vapor_tpu_torch/sim/scale.py build_scale_case.  An untimed run over its
first 24 events builds the kernels first.  Reports events/s,
reads scored/s and TP/FN/FP/TN against the fixture's truth, a call
being a quality score above 0.2.
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


def tally(path, truth):
    """Rows, per-read scores (VaPoR_Rec) and TP/FN/FP/TN of a bed output
    against truth {sv id: True for a true event}: an event is called
    when its quality score is neither NA nor empty and above 0.2."""
    n_rows = reads = tp = fn = fp = tn = 0
    with open(path) as fin:
        for line in fin:
            if line.startswith("#"):
                continue
            cols = line.rstrip("\n").split("\t")
            n_rows += 1
            svid, qs, rec = cols[4], cols[5], cols[9]
            if rec not in ("NA", ""):
                reads += len(rec.split(","))
            is_true = truth.get(svid)
            called = qs not in ("NA", "") and float(qs) > 0.2
            if is_true and called:
                tp += 1
            elif is_true:
                fn += 1
            elif called:
                fp += 1
            else:
                tn += 1
    return {"events": n_rows, "reads_evaluated": reads, "TP": tp, "FN": fn,
            "FP": fp, "TN": tn}


def main(argv=None):
    env = os.environ
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=env.get("SCALE_DEVICE", "cuda"),
                    choices=["cuda", "cpu"])
    ap.add_argument("--out", default=os.path.join(
        REPO, "chiprun_out", "scale_run_torch.json"))
    args = ap.parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("scale_run_torch: no CUDA card (--device cpu or "
              "SCALE_DEVICE=cpu runs on the CPU)", file=sys.stderr)
        return 1
    n_contigs = int(env.get("SCALE_CONTIGS", "4"))
    contig_len = int(env.get("SCALE_LEN", "150000"))
    events_per = int(env.get("SCALE_EVENTS", "24"))
    mode = env.get("SCALE_MODE", "pipeline")
    backend = env.get("SCALE_BACKEND", "torch")
    pipeline = int(env.get("SCALE_PIPELINE", "8"))
    from vapor_tpu_torch.sim.scale import build_scale_case
    with tempfile.TemporaryDirectory(prefix="vapor_scale_") as tmp:
        print(f"building case: {n_contigs} contigs x {contig_len} bp, "
              f"~{events_per} events/contig ...", flush=True)
        case = build_scale_case(tmp, n_contigs=n_contigs,
                                contig_len=contig_len,
                                events_per=events_per)
        out = os.path.join(tmp, "out.vapor")
        flags = ["--no-figures", "--pipeline", str(pipeline)]
        from vapor_tpu_torch.cli import main as cli_main

        def bed_run(bed, out_file):
            with open(os.devnull, "w") as devnull, \
                    contextlib.redirect_stdout(devnull):
                rc = cli_main(["bed", "--sv-input", bed,
                               "--reference", case["fasta"],
                               "--pacbio-input", case["bam"],
                               "--output-path", os.path.join(tmp, "figs/"),
                               "--output-file", out_file, "--backend",
                               backend, "--device", args.device, *flags])
            if rc != 0:
                raise RuntimeError(f"bed CLI exited {rc}")

        # untimed: the first 24 events build the kernels and the codec
        head = os.path.join(tmp, "head.bed")
        with open(case["bed"]) as fh, open(head, "w") as fo:
            fo.writelines(line for line, _ in zip(fh, range(24)))
        bed_run(head, os.path.join(tmp, "head.vapor"))
        t0 = time.perf_counter()
        if mode == "scatter":
            from vapor_tpu_torch.orchestrate import run_scatter
            run_scatter("bed", case["bed"], case["fasta"], case["bam"],
                        os.path.join(tmp, "figs"), out,
                        jobs=int(env.get("SCALE_JOBS", "1")),
                        backend=backend, device=args.device,
                        extra_args=flags)
        else:
            bed_run(case["bed"], out)
            if args.device == "cuda":
                torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        t = tally(out, case["truth"])
    print(f"events={t['events']} wall={wall:.1f}s "
          f"events/s={t['events'] / wall:.2f} "
          f"reads_evaluated={t['reads_evaluated']} "
          f"reads/s={t['reads_evaluated'] / wall:.1f}")
    print(f"accuracy: TP={t['TP']} FN={t['FN']} FP={t['FP']} TN={t['TN']} "
          f"sens={t['TP'] / max(1, t['TP'] + t['FN']):.3f} "
          f"spec={t['TN'] / max(1, t['TN'] + t['FP']):.3f}")
    report = {"mode": mode, "backend": backend, "device": args.device,
              "contigs": n_contigs, "contig_len": contig_len,
              "events_per": events_per, "pipeline": pipeline, "wall_s": wall,
              "events_per_s": t["events"] / wall,
              "reads_per_s": t["reads_evaluated"] / wall, **t}
    if args.device == "cuda":
        from vapor_tpu_torch.engine.kernels.roofline import card_line
        report["card"] = card_line()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fo:
        json.dump(report, fo, indent=1)
    print(json.dumps({k: report[k] for k in (
        "mode", "device", "card", "events_per_s") if k in report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
