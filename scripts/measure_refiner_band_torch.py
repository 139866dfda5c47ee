"""How often vapor_tpu_torch's window refiner leaves the card for its
band QC, and what a band hit costs.

The device refiner (vapor_tpu_torch/engine/window_device.py) decides the
k-mer window from three integers of the hap's self-comparison, which
goes through the hist kernel as its own read.  Only when the
below-diagonal fraction lands in (0.1, 0.5) does it run the exact host
QC (numpy self-dots and seeded X-means) on a worker thread: a per-event
host stall.  Reference gate: window_size_refine,
vapor_vali/Simple_function.pyx:2030-2046.  Two legs:

1. **corpus**: the truth corpus (sim/corpus.py build_corpus, 3 contigs
   x 60 kb, seed 77, het and homo) through the vcf subcommand on the
   card, counting band hits in window_device.BAND_STATS.
2. **repeat-heavy**: the 108 tandem-array haps of sim/corpus.py
   repeat_cases (periods 15/40/100, repeat fraction 0.2-0.8 of spans
   600/1200/2400, 5% point noise between copies) through
   DeviceWindowRefiner(region_qc_cff=0.4, seed=0) on the card.  Repeats
   put mass below the diagonal.  A hap's stall is the time from
   refine()'s call to its return, for each hap that hit the band; the
   hist self-stats launches are counted over the leg.

    python3 scripts/measure_refiner_band_torch.py [--device cuda]
        [--out chiprun_out/refiner_band_torch.json]
"""
import argparse
import contextlib
import json
import os
import statistics
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _band_delta(before):
    from vapor_tpu_torch.engine.window_device import BAND_STATS
    return {k: BAND_STATS[k] - before[k] for k in before}


def corpus_leg(device: str):
    from vapor_tpu_torch.cli import main as cli_main
    from vapor_tpu_torch.engine.window_device import BAND_STATS
    from vapor_tpu_torch.sim.corpus import build_corpus
    out = {}
    for zygosity in ("het", "homo"):
        with tempfile.TemporaryDirectory(
                prefix=f"vapor_band_{zygosity}_") as d:
            fa, bam, vcf, truth = build_corpus(
                d, zygosity, n_contigs=3, contig_len=60000, seed=77)
            before = dict(BAND_STATS)
            t0 = time.perf_counter()
            with open(os.devnull, "w") as devnull, \
                    contextlib.redirect_stdout(devnull):
                rc = cli_main(["vcf", "--sv-input", vcf, "--reference", fa,
                               "--pacbio-input", bam, "--output-path",
                               os.path.join(d, "figs"), "--device", device,
                               "--no-figures"])
            if rc != 0:
                raise RuntimeError(f"vcf CLI exited {rc}")
            stats = _band_delta(before)
            stats["wall_s"] = time.perf_counter() - t0
            stats["calls"] = len(truth)
            out[zygosity] = stats
    return out


def repeat_leg(device: str):
    import torch
    from vapor_tpu_torch.engine import kernels
    from vapor_tpu_torch.engine.window_device import (BAND_STATS,
                                                      DeviceWindowRefiner)
    from vapor_tpu_torch.sim.corpus import repeat_cases
    refiner = DeviceWindowRefiner(region_qc_cff=0.4, seed=0, device=device)
    cases = repeat_cases()
    kernels.reset_counts()
    results = {}
    stall_s = []
    t_leg = time.perf_counter()
    for period, rep_frac, span, hap in cases:
        before = dict(BAND_STATS)
        t0 = time.perf_counter()
        w = refiner.refine(hap)
        dt = time.perf_counter() - t0
        d = _band_delta(before)
        key = f"p{period}_f{rep_frac}"
        ent = results.setdefault(key, {"n": 0, "band_hits": 0,
                                       "windows": []})
        ent["n"] += 1
        ent["band_hits"] += d["band_hits"]
        ent["windows"].append(w)
        if d["band_hits"]:
            stall_s.append(dt)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t_leg
    total = sum(e["n"] for e in results.values())
    hits = sum(e["band_hits"] for e in results.values())
    return {
        "cases": total,
        "band_hits": hits,
        "hit_rate": hits / total,
        "haps_that_hit": len(stall_s),
        "wall_s": wall,
        "selfstats_launches": sum(
            n for (name, route, _, _), n in kernels.LAUNCH_SHAPES.items()
            if name == "hist" and route == "selfstats"),
        "host_stall_s_when_hit": {
            "n": len(stall_s),
            "total": sum(stall_s),
            "mean": statistics.mean(stall_s) if stall_s else None,
            "median": statistics.median(stall_s) if stall_s else None,
            "max": max(stall_s) if stall_s else None},
        "by_config": {k: {"n": v["n"], "band_hits": v["band_hits"],
                          "windows": sorted(set(v["windows"]),
                                            key=lambda x: (x is None, x))}
                      for k, v in sorted(results.items())},
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=os.path.join(
        REPO, "chiprun_out", "refiner_band_torch.json"))
    args = ap.parse_args()
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("measure_refiner_band_torch: no CUDA card (--device cpu "
              "runs on the CPU)", file=sys.stderr)
        return 1
    report = {"device": args.device,
              "card": torch.cuda.get_device_name(0)
              if args.device == "cuda" else None,
              "corpus": corpus_leg(args.device),
              "repeat_heavy": repeat_leg(args.device)}
    corpus_calls = sum(v["refine_calls"] for v in report["corpus"].values())
    corpus_hits = sum(v["band_hits"] for v in report["corpus"].values())
    rh = report["repeat_heavy"]
    report["summary"] = {
        "corpus_refine_calls": corpus_calls,
        "corpus_band_hits": corpus_hits,
        "corpus_hit_rate": corpus_hits / corpus_calls
        if corpus_calls else None,
        "repeat_heavy_hit_rate": rh["hit_rate"],
        "repeat_heavy_haps_that_hit": rh["haps_that_hit"],
        "repeat_heavy_stall_mean_s": rh["host_stall_s_when_hit"]["mean"],
        "repeat_heavy_stall_max_s": rh["host_stall_s_when_hit"]["max"],
        "repeat_heavy_selfstats_launches": rh["selfstats_launches"],
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fo:
        json.dump(report, fo, indent=1)
    print(json.dumps(report["summary"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
