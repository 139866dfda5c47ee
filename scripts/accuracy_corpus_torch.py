"""The ten-class truth corpus through vapor_tpu_torch, het and homo.

A spec-driven truth set over several contigs (vapor_tpu_torch/sim/
corpus.py build_corpus: all ten reference edit classes, spanning long
reads around every breakpoint, het = half donor / half reference reads,
homo = all donor, plus deliberate FALSE calls in SV-free regions) goes
through the vcf subcommand with --validate-vcf-tandup (without it, vcf
mode drops every DUP record) on the card, and the annotated VCF is
scored per class: sensitivity = the share of true calls with VaPor_GS
>= GS_CFF, false_validation_rate the same share over the false calls.

Beside each zygosity's per-class results the report holds events/s and
reads scored/s (per-read scores in VaPor_REC) from the call of
cli.main to its return and a device sync, after an untimed warm pass
over the first 12 calls, the launches of each kernel
(the counts that --trace reports) and the window refiner's BAND_STATS
over the run, and whether the per-class results equal ACCURACY_r5.json's
(the JAX package's results on the same corpus; compared only at the
default sizes and seed).

    python3 scripts/accuracy_corpus_torch.py [--contigs 4]
        [--contig-len 400000] [--seed 20260821] [--device cuda]
        [--backend torch] [--out chiprun_out/accuracy_corpus_torch.json]

Homo uses seed + 1.  The default run needs one CUDA card; --device cpu
runs the same on the CPU.
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

DEFAULTS = {"contigs": 4, "contig_len": 400000, "seed": 20260821}


def reads_scored(vcf_vapor: str) -> int:
    """Per-read scores in the annotated VCF's VaPor_REC fields."""
    n = 0
    with open(vcf_vapor) as fh:
        for line in fh:
            if line.startswith("#") or "VaPor_REC=" not in line:
                continue
            rec = line.split("VaPor_REC=")[1].split("\t")[0].split(";")[0]
            if rec not in ("NA", ""):
                n += len([x for x in rec.split(",") if x])
    return n


def run_zygosity(d, zygosity, args):
    """Builds one corpus under d, scores it through the CLI and returns
    its report entry."""
    import torch
    from vapor_tpu_torch.cli import main as cli_main
    from vapor_tpu_torch.engine import kernels, window_device
    from vapor_tpu_torch.sim.corpus import (build_corpus, evaluate,
                                            parse_annotated)
    t0 = time.perf_counter()
    fa, bam, vcf, truth = build_corpus(
        d, zygosity, args.contigs, args.contig_len,
        seed=args.seed + (0 if zygosity == "het" else 1))
    build_s = time.perf_counter() - t0
    n_true = sum(1 for v in truth.values() if not v.startswith("FALSE"))
    print(f"{zygosity}: {len(truth)} calls ({n_true} true), built in "
          f"{build_s:.1f} s", flush=True)

    def run(sv_input):
        t0 = time.perf_counter()
        with open(os.devnull, "w") as devnull, \
                contextlib.redirect_stdout(devnull):
            rc = cli_main(["vcf", "--sv-input", sv_input, "--reference", fa,
                           "--pacbio-input", bam,
                           "--output-path", os.path.join(d, "figs"),
                           "--backend", args.backend, "--device",
                           args.device, "--no-figures",
                           "--validate-vcf-tandup"])
        if args.device == "cuda":
            torch.cuda.synchronize()
        if rc != 0:
            raise RuntimeError(f"vcf CLI exited {rc} on {sv_input}")
        return time.perf_counter() - t0

    # untimed warm pass over the first 12 calls: the process's first
    # run loads the kernels and builds the native BAM codec (the
    # corpus BAM has no index)
    head = os.path.join(d, "head.vcf")
    with open(vcf) as fh, open(head, "w") as fo:
        lines = fh.readlines()
        n_meta = sum(1 for x in lines if x.startswith("#"))
        fo.writelines(lines[:n_meta + 12])
    warm_s = run(head)
    kernels.reset_counts()
    band0 = dict(window_device.BAND_STATS)
    wall = run(vcf)
    n_reads = reads_scored(vcf + ".vapor")
    return {
        "calls": len(truth), "true_calls": n_true,
        "build_s": build_s, "warm_s": warm_s, "wall_s": wall,
        "events_per_s": len(truth) / wall,
        "reads_scored": n_reads, "reads_per_s": n_reads / wall,
        "launches": dict(kernels.LAUNCHES),
        "band_stats": {k: window_device.BAND_STATS[k] - band0[k]
                       for k in band0},
        "per_class": evaluate(parse_annotated(vcf + ".vapor"), truth),
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--contigs", type=int, default=DEFAULTS["contigs"])
    ap.add_argument("--contig-len", type=int,
                    default=DEFAULTS["contig_len"])
    ap.add_argument("--seed", type=int, default=DEFAULTS["seed"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--backend", default="torch",
                    choices=["torch", "torch-nobatch", "numpy"])
    ap.add_argument("--out", default=os.path.join(
        REPO, "chiprun_out", "accuracy_corpus_torch.json"))
    args = ap.parse_args()
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("accuracy_corpus_torch: no CUDA card (--device cpu runs on "
              "the CPU)", file=sys.stderr)
        return 1
    from vapor_tpu_torch.sim.corpus import GS_CFF
    at_defaults = all(getattr(args, k) == v for k, v in DEFAULTS.items())
    reference = None
    ref_path = os.path.join(REPO, "ACCURACY_r5.json")
    if at_defaults and os.path.exists(ref_path):
        with open(ref_path) as fh:
            reference = json.load(fh)["zygosity"]
    report = {"device": args.device, "backend": args.backend,
              "card": torch.cuda.get_device_name(0)
              if args.device == "cuda" else None,
              "contigs": args.contigs, "contig_len": args.contig_len,
              "seed": args.seed, "gs_cff": GS_CFF, "zygosity": {}}
    for zygosity in ("het", "homo"):
        with tempfile.TemporaryDirectory(
                prefix=f"vapor_corpus_{zygosity}_") as d:
            entry = run_zygosity(d, zygosity, args)
        if reference is not None:
            entry["equals_ACCURACY_r5"] = \
                entry["per_class"] == reference[zygosity]["per_class"]
        report["zygosity"][zygosity] = entry
        print(json.dumps({k: v for k, v in entry.items()
                          if k != "per_class"}), flush=True)
        print(json.dumps({k: {m: x for m, x in v.items()
                              if m != "gs_values"}
                          for k, v in entry["per_class"].items()}),
              flush=True)
    report["total_calls"] = sum(v["calls"]
                                for v in report["zygosity"].values())
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fo:
        json.dump(report, fo, indent=1)
    print(f"wrote {args.out} ({report['total_calls']} calls)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
