#!/usr/bin/env python3
"""On-card smoke run of vapor_tpu_torch: builds its CUDA kernels, holds
each against its plain PyTorch version, scores a synthetic DEL/INV bed
worklist through the CLI on the card, and checks the rows against the
CPU and numpy-oracle runs.

    python3 chip_smoke.py [--seed N] [--reps N]

Phases, each fatal on failure: 1 build, 2 input, 3 kernel parity and
timing, 4 end to end on cuda, 5 CPU and oracle cross-check, 6 kernel
list.  The last line of stdout is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Needs one CUDA card and nvcc; exits non-zero without them.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

# Peak rates of one H100 SXM (NVIDIA data sheet, at the 700 W limit): HBM
# bytes/s, and the CUDA-core (non-tensor) rate, which bounds integer
# compares from below (Hopper's INT32 pipe runs at half of it).
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
# per-hit accumulations of each kernel, beside 2 strands x lanes
# compares per eligible cell
HIT_OPS = {"hist": 4, "left_hist": 1, "moment": 3, "moment2": 5}
SIZES = (400, 3000, 9500)     # smallest, middle and largest event bodies
# where each kernel's Pallas counterpart reaches pl.pallas_call
REPLACES = {
    "hist": "experiments/pallas_fused.py:268",
    "left_hist": "experiments/pallas_fused.py:420",
    "moment": "experiments/pallas_fused.py:734",
    "moment2": "experiments/pallas_fused.py:851",
}


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(what)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def _time_ms(fn, reps: int) -> float:
    import torch
    fn()                                    # warm
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# ---------------------------------------------------------------------------
# phase 3: kernel parity at the main path's shapes
# ---------------------------------------------------------------------------

def _event_rows(fa, bam, event, mode: str):
    """The reference-hap rows one main-path call of `mode` gets for this
    event (largest read group): INV whole-event (m1b) rows have reads
    through the whole event, DEL (del mode) rows reads across the left
    breakpoint."""
    import numpy as np
    from vapor_tpu_torch.engine.fused import FusedBackend
    from vapor_tpu_torch.grammar.letters import flank_length_calculate
    from vapor_tpu_torch.io.fasta import FastaFile
    from vapor_tpu_torch.io.reads import collect_event_reads
    from vapor_tpu_torch.engine.constants import bucket_for
    _, s, e = event
    flank = flank_length_calculate(["chrE", s, e])
    hap = FastaFile(fa).fetch("chrE", s - flank, e + flank).upper()
    end = e + flank if mode == "m1b" else s + flank
    reads = collect_event_reads(bam, "chrE", s - flank, end, flank, 20)
    be = FusedBackend("cpu")
    R, idxs = max(be._read_groups(reads), key=lambda g: len(g[1]))
    H = bucket_for(len(hap) + 1)
    fw, rlens, ms = be._encode_reads([reads[i] for i in idxs], R)
    haps = np.broadcast_to(be._encode_hap(hap, H), (len(idxs), H))
    return haps, fw, rlens, ms


def _bound(name: str, codes, outs, tables, hits: int):
    """(least ms the card could take, "bytes" or "operations")."""
    ch, cf, cd, ms, rlens, k = codes
    H, R = ch.shape[2], cf.shape[2]
    lanes = ch.shape[1]
    cells = sum(max(0, H - m) * max(0, min(rl - k, R - 1) + 1)
                for m, rl in zip(ms.tolist(), rlens.tolist()))
    ops = cells * 2 * lanes + hits * HIT_OPS[name]
    nbytes = sum(t.numel() * t.element_size()
                 for t in (ch, cf, cd, ms, rlens, *tables, *outs))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ALU_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes > t_ops else "operations"


def kernel_parity(fa, bam, events, reps: int):
    """Each kernel against its plain version at the smallest, middle and
    largest event sizes, k = 10 and 40; every output integer must be
    equal.  Returns {name: stats at the largest size, k = 10}."""
    import torch
    from vapor_tpu_torch.engine import kernels
    from vapor_tpu_torch.engine.fused import (batch_from_numpy, kept_table,
                                              row_codes)
    dev = torch.device("cuda")
    report = {}
    for body in SIZES:
        inv = next(ev for ev in events if ev[0] == "INV" and
                   ev[2] - ev[1] == body)
        dele = next(ev for ev in events if ev[0] == "DEL" and
                    ev[2] - ev[1] == body)
        for k in (10, 40):
            cases = {}
            for mode, ev in (("m1b", inv), ("del", dele)):
                haps, fw, rlens, ms = _event_rows(fa, bam, ev, mode)
                h, r, rl, m, _ = batch_from_numpy(haps, fw, rlens, ms,
                                                  k // 10 - 1, dev)
                codes = (*row_codes(h, r, rl, k), m, rl, k)
                h_d, h_a, scal = kernels.hist_plain(*codes)
                hits = int(scal[:, :2].sum())
                kd, ka = (kept_table(x, 10, 10, False) for x in (h_d, h_a))
                kd50 = kept_table(h_d, 10, 50, True)
                ka50 = kept_table(kernels.left_hist_plain(*codes, kd50),
                                  10, 50, True)
                cases[mode] = (codes, hits, kd, ka, kd50, ka50)
            codes_i, hits_i, kd_i, ka_i, _, _ = cases["m1b"]
            codes_d, hits_d, kd_d, ka_d, kd50, ka50 = cases["del"]
            runs = {
                "hist": (codes_i, hits_i, (),
                         lambda c=codes_i: kernels.hist(*c),
                         lambda c=codes_i: kernels.hist_plain(*c)),
                "moment": (codes_i, hits_i, (kd_i, ka_i),
                           lambda c=codes_i: kernels.moment(
                               *c, kd_i, ka_i, False),
                           lambda c=codes_i: kernels.moment_plain(
                               *c, kd_i, ka_i, False)),
                "left_hist": (codes_d, hits_d, (kd50,),
                              lambda c=codes_d: kernels.left_hist(*c, kd50),
                              lambda c=codes_d: kernels.left_hist_plain(
                                  *c, kd50)),
                "moment2": (codes_d, hits_d, (kd_d, ka_d, kd50, ka50),
                            lambda c=codes_d: kernels.moment2(
                                *c, kd_d, ka_d, kd50, ka50),
                            lambda c=codes_d: kernels.moment2_plain(
                                *c, kd_d, ka_d, kd50, ka50)),
            }
            for name, (codes, hits, tables, kern, plain) in runs.items():
                got, want = kern(), plain()
                torch.cuda.synchronize()
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                err = max(int((g.long() - w.long()).abs().max())
                          for g, w in zip(got, want))
                _require(err == 0, f"{name} differs from its plain version "
                         f"at body {body}, k={k}: max |diff| {err}")
                ms_k = _time_ms(kern, reps)
                ms_p = _time_ms(plain, 1)
                bound, bound_by = _bound(name, codes, got, tables, hits)
                H, R = codes[0].shape[2], codes[1].shape[2]
                B = codes[0].shape[0]
                print(f"parity {name:9s} B={B:2d} H={H:5d} R={R:5d} k={k}: "
                      f"equal; kernel {ms_k:.4f} ms, plain {ms_p:.3f} ms, "
                      f"bound {bound:.4f} ms", flush=True)
                prev = report.get(name, {"max_abs_err": 0})
                entry = {"max_abs_err": max(prev["max_abs_err"], err)}
                if body == SIZES[-1] and k == 10:
                    entry.update(ms=ms_k, plain_ms=ms_p, bound_ms=bound,
                                 bound_by=bound_by,
                                 shape=f"B={B} H={H} R={R} k={k}")
                else:
                    entry.update({x: prev[x] for x in (
                        "ms", "plain_ms", "bound_ms", "bound_by", "shape")
                        if x in prev})
                report[name] = entry
    return report


# ---------------------------------------------------------------------------
# phases 4-5: the CLI
# ---------------------------------------------------------------------------

def run_cli(fa, bam, bed, out, backend="torch", device="cuda"):
    from vapor_tpu_torch.cli import main
    rc = main(["bed", "--sv-input", bed, "--reference", fa,
               "--pacbio-input", bam, "--output-path",
               os.path.join(os.path.dirname(out), "figs"),
               "--output-file", out, "--backend", backend,
               "--device", device, "--no-figures"])
    _require(rc == 0, f"CLI ({backend}, {device}) exited {rc}")
    with open(out) as fh:
        return [line for line in fh.read().splitlines()
                if not line.startswith("#")]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--reps", type=int, default=5,
                    help="timed launches per kernel and shape")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    try:
        from vapor_tpu_torch.engine import kernels
        from vapor_tpu_torch.engine.kernels import build
        from vapor_tpu_torch.sim.scale import build_event_worklist
    except ImportError as exc:
        print(f"chip_smoke: vapor_tpu_torch not importable: {exc}",
              file=sys.stderr)
        return 1
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"card {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    build.build()
    print(f"phase 1 build: {time.perf_counter() - t0:.1f} s", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        fa, bam, bed, events = build_event_worklist(tmp, args.seed)
        print(f"phase 2 input: {len(events)} events in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

        report = kernel_parity(fa, bam, events, args.reps)
        print("phase 3 kernel parity: all equal", flush=True)

        kernels.reset_counts()
        t0 = time.perf_counter()
        rows = run_cli(fa, bam, bed, os.path.join(tmp, "cuda.vapor"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        plain_on_cuda = dict(kernels.PLAIN_CUDA_CALLS)
        _require(len(rows) == len(events),
                 f"{len(rows)} rows for {len(events)} events")
        _require(all(n > 0 for n in launches.values()),
                 f"a kernel of the path never launched: {launches}")
        _require(not any(plain_on_cuda.values()),
                 f"plain versions ran on CUDA tensors: {plain_on_cuda}")
        called = [r.split("\t") for r in rows if r.split("\t")[5] != "NA"]
        _require(all(math.isfinite(float(c[5])) for c in called),
                 "non-finite quality score")
        n_reads = sum(len(c[9].split(",")) for c in called)
        print(f"phase 4 end to end: {len(rows)} events, {len(called)} "
              f"called, {n_reads} reads scored in {wall:.2f} s: "
              f"{len(rows) / wall:.2f} events/s, "
              f"{n_reads / wall:.1f} reads/s; launches {launches}",
              flush=True)

        small = os.path.join(tmp, "small.bed")
        with open(bed) as fh, open(small, "w") as fo:
            fo.writelines(fh.readlines()[:4])
        for backend, device in (("torch", "cpu"), ("numpy", "cpu")):
            ref = run_cli(fa, bam, small,
                          os.path.join(tmp, f"{backend}.vapor"),
                          backend=backend, device=device)
            _require(ref == rows[:4], f"{backend} on {device} differs "
                     f"from the card on the 4 smallest events")
        print("phase 5 cross-check: the card's rows for the 4 smallest "
              "events equal the CPU and numpy-oracle runs byte for byte",
              flush=True)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"vapor_tpu_torch/engine/kernels/csrc/{name}.cu",
         "replaces": REPLACES[name],
         "launches": launches[name],
         "max_abs_err": report[name]["max_abs_err"],
         "ms": report[name]["ms"], "plain_ms": report[name]["plain_ms"],
         "bound_ms": report[name]["bound_ms"],
         "bound_by": report[name]["bound_by"],
         "library_ms": None, "shape": report[name]["shape"]}
        for name in kernels.NAMES]}))
    print(_card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
