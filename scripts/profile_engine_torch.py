#!/usr/bin/env python3
"""Stage profile of vapor_tpu_torch's fused engine on the card, at the
JAX engine profile's row shapes, with a verdict on what bounds each
stage.

Rows: make_rows(H, R, B) with seed 7, the JAX package's profile rows
(scripts/profile_engine.py): one random hap of H - 30 bases per bucket,
each read its first R - 40 bases with a twelfth of them substituted.
For each bucket H = R (PROFILE_BUCKETS, default 1536, 3072 and 12544,
the main path's largest m1b bucket), B = PROFILE_ROWS rows (48):

* stages timed with CUDA events after a warm-up call, PROFILE_REPS
  calls each (5; the least is reported):
  codes  row_codes (engine/fused.py, the codes kernel on the card):
         packed hap, forward and dot-space reverse-strand k-mer codes,
         k = 10;
  hist   the hist kernel alone, on those codes;
  full   fused_batch for each scorer (m1b, del, w10, rdd): codes, the
         mode's kernels, the keep-table and intercept kernels and the
         few torch ops between them;
* against each stage, its bound: the larger of the bytes it must move
  over 3.35 TB/s and its integer operations over 16.73 T/s
  (vapor_tpu_torch/engine/kernels/roofline.py, which chip_smoke.py
  uses too; full counts its codes and each of the six kernels it
  launches, the keep tables and the intercept not), and a verdict:
  memory-bound when the stage moves its bytes at 50% or more of the
  memory rate, operations-bound at 30% or more of the integer rate,
  launch/host-bound otherwise;
* one torch.profiler pass per bucket and scorer that splits full's
  device time into the six kernels and the glue: row_codes,
  kept_tables, intercept_z (record_function ranges around the glue
  kernels' wrappers), the scan kernels (cumsum, cummax) among them
  (none on the card since the glue runs as kernels), and the rest.

The JAX script's TPU v5e peaks are not used here.  Prints a line per
stage and one JSON object; writes it to --out.  --device cpu computes
each stage's work and bound on the CPU, and times nothing.

    python3 scripts/profile_engine_torch.py [--device cuda|cpu]
        [--out chiprun_out/profile_engine_torch.json]
"""
import argparse
import contextlib
import functools
import json
import os
import re
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

REPS = int(os.environ.get("PROFILE_REPS", "5"))
B = int(os.environ.get("PROFILE_ROWS", "48"))
BUCKETS = [int(x) for x in
           os.environ.get("PROFILE_BUCKETS", "1536,3072,12544").split(",")]
SCORERS = ("m1b", "del", "w10", "rdd")
# the glue kernels' wrappers, which fused_rows calls as kernels.<name>
GLUE = ("row_codes", "kept_tables", "intercept_z")
K = 10


def make_rows(H, R, B, seed=7):
    """(haps, reads, rcs, rlens, ms): the JAX profile's rows, draw for
    draw (rcs, the reads' reverse complements, are derived on the
    device by the port and are not uploaded)."""
    from vapor_tpu_torch.engine.constants import HAP_PAD, READ_PAD
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    hap_len, rlen = H - 30, R - 40
    haps = np.full((B, H), HAP_PAD, np.uint8)
    reads = np.full((B, R), READ_PAD, np.uint8)
    hap = bases[rng.integers(0, 4, hap_len)]
    comp = np.zeros(256, np.uint8)
    for a, b in zip(b"ACGT", b"TGCA"):
        comp[a] = b
    rcs = np.full((B, R), READ_PAD, np.uint8)
    for i in range(B):
        seq = hap[:rlen].copy()
        flips = rng.integers(0, rlen, rlen // 12)
        seq[flips] = bases[rng.integers(0, 4, flips.size)]
        haps[i, :hap_len] = hap
        reads[i, :rlen] = seq
        rcs[i, :rlen] = comp[seq[::-1]]
    rlens = np.full(B, rlen, np.int32)
    ms = np.zeros(B, np.int32)
    return haps, reads, rcs, rlens, ms


def time_ms(fn, reps):
    """Each of reps calls on CUDA events after one warm call; ms."""
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(stop))
    return out


@contextlib.contextmanager
def recorded_kernels():
    """Records (name, arguments, output) of every kernel wrapper call
    made inside the block."""
    from vapor_tpu_torch.engine import kernels
    calls, originals = [], {n: getattr(kernels, n) for n in kernels.NAMES}

    def wrap(name):
        @functools.wraps(originals[name])
        def call(*a, **kw):
            out = originals[name](*a, **kw)
            calls.append((name, a, out))
            return out
        return call
    for name in kernels.NAMES:
        setattr(kernels, name, wrap(name))
    try:
        yield calls
    finally:
        for name, fn in originals.items():
            setattr(kernels, name, fn)


@contextlib.contextmanager
def labelled_glue():
    """Opens a record_function range around each call of the glue
    kernels' wrappers that fused_rows calls by name."""
    from torch.profiler import record_function
    from vapor_tpu_torch.engine import kernels
    originals = {n: getattr(kernels, n) for n in GLUE}

    def wrap(name):
        @functools.wraps(originals[name])
        def call(*a, **kw):
            with record_function(f"glue:{name}"):
                return originals[name](*a, **kw)
        return call
    for name in GLUE:
        setattr(kernels, name, wrap(name))
    try:
        yield
    finally:
        for name, fn in originals.items():
            setattr(kernels, name, fn)


def kernels_work(calls, hap_lens):
    """{kernel: (bytes, operations)} of the recorded kernel calls of one
    fused_batch (hits from its hist call's gate scalars)."""
    import torch
    from vapor_tpu_torch.engine.kernels.roofline import kernel_work
    hits = next(int(out[2][:, :2].sum()) for name, _, out in calls
                if name == "hist")
    work = {}
    for name, a, out in calls:
        outs = out if isinstance(out, tuple) else (out,)
        tables = tuple(x for x in a[6:] if isinstance(x, torch.Tensor))
        nbytes, ops = kernel_work(name, a[:6], hap_lens, outs, tables, hits)
        b0, o0 = work.get(name, (0, 0))
        work[name] = (b0 + nbytes, o0 + ops)
    return work, hits


def verdict(nbytes, ops, ms):
    from vapor_tpu_torch.engine.kernels.roofline import (HBM_BYTES_PER_S,
                                                         INT32_OPS_PER_S)
    s = ms / 1e3
    bw, rate = nbytes / s / HBM_BYTES_PER_S, ops / s / INT32_OPS_PER_S
    return bw, rate, ("memory-bound" if bw >= 0.5 else
                      "operations-bound" if rate >= 0.3 else
                      "launch/host-bound")


def stage_row(nbytes, ops, times):
    """One stage's numbers; times None (a CPU run) leaves its time and
    verdict out."""
    from vapor_tpu_torch.engine.kernels.roofline import bound
    bound_ms, bound_by = bound(nbytes, ops)
    row = {"bytes": nbytes, "operations": ops, "bound_ms": bound_ms,
           "bound_by": bound_by}
    if times:
        ms = min(times)
        bw, rate, word = verdict(nbytes, ops, ms)
        row.update(ms=ms, ms_per_row=ms / B, times_ms=times,
                   x_bound=ms / bound_ms, memory_rate_frac=bw,
                   int32_rate_frac=rate, verdict=word)
    return row


def device_split(full):
    """full's device time under torch.profiler: the six kernels, the
    glue (each range's torch ops, and its glue kernel by name: the
    profiler gives a range no kernel launched through ctypes), the scan
    kernels among the glue, and the rest (ms)."""
    from profile_torch_bed import device_profile
    with labelled_glue():
        split = device_profile(full, labels=[f"glue:{n}" for n in GLUE])
    ours = {n: 1e3 * t for n, t in split["our_kernels_s"].items() if t}
    glue_kernels = split.get("glue_kernels_s", {})
    glue = {}
    for label, t in split["labelled_s"].items():
        name = label[len("glue:"):]
        parts = [x for x in (t, glue_kernels.get(name)) if x]
        glue[name] = 1e3 * sum(parts) if parts else None
    device_ms = 1e3 * split["device_busy_s"]
    return {"device": device_ms, "kernels": ours,
            "kernels_total": sum(ours.values()), "glue": glue,
            "glue_scan_kernels": 1e3 * sum(
                t for key, t in split["device_kernels_s"].items()
                if re.search(r"scan|cumsum|cummax", key, re.I)),
            "glue_rest": device_ms - sum(ours.values())
            - sum(t for t in glue.values() if t),
            "top": {k: 1e3 * t for k, t in
                    split["top_device_kernels_s"].items()}}


def profile_bucket(H, device):
    """The stages of bucket H = R on device: their work and bounds, and
    on the card their times, verdicts and full's device split."""
    from vapor_tpu_torch.engine import kernels
    from vapor_tpu_torch.engine.constants import HAP_PAD
    from vapor_tpu_torch.engine.fused import (batch_from_numpy, fused_batch,
                                              row_codes)
    from vapor_tpu_torch.engine.kernels import roofline
    R = H
    on_card = device.type == "cuda"
    haps, reads, _, rlens, ms = make_rows(H, R, B)
    hap_lens = [int(n) for n in (haps != HAP_PAD).sum(1)]
    h, r, rl, m, k_idx = batch_from_numpy(haps, reads, rlens, ms,
                                          K // 10 - 1, device)
    codes = (*row_codes(h, r, rl, K), m, rl, K)

    def timed(fn):
        return time_ms(fn, REPS) if on_card else None

    stages = {}
    c_work = roofline.codes_work(h, r, rl, codes[:3], K)
    stages["codes"] = stage_row(*c_work,
                                timed(lambda: row_codes(h, r, rl, K)))
    with recorded_kernels() as calls:
        kernels.hist(*codes)
    work, hits = kernels_work(calls, hap_lens)
    stages["hist"] = stage_row(*work["hist"],
                               timed(lambda: kernels.hist(*codes)))
    for scorer in SCORERS:
        def full(s=scorer):
            return fused_batch(h, r, rl, m, k_idx, H, R, s)
        with recorded_kernels() as calls:
            full()
        work, _ = kernels_work(calls, hap_lens)
        row = stage_row(c_work[0] + sum(b for b, _ in work.values()),
                        c_work[1] + sum(o for _, o in work.values()),
                        timed(full))
        row["kernels"] = [name for name, _, _ in calls]
        if on_card:
            row["device_split_ms"] = device_split(full)
        stages[f"full_{scorer}"] = row
    return {"H": H, "R": R, "rows": B, "hits": hits, "stages": stages}


def _line(H, name, row, card):
    if "ms" not in row:
        return (f"H={H} {name}: bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']}); time not measured on the CPU")
    split = row.get("device_split_ms")
    extra = "" if not split else (
        f"; device {split['device']:.3f} ms: kernels "
        f"{split['kernels_total']:.3f}, glue " + ", ".join(
            f"{n} " + ("not measured" if t is None else f"{t:.3f}")
            for n, t in split["glue"].items())
        + f", scans {split['glue_scan_kernels']:.3f}, rest "
        f"{split['glue_rest']:.3f}")
    return (f"H={H} {name}: {row['ms']:.4f} ms ({row['ms_per_row']:.5f} "
            f"ms/row), bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
            f"{row['x_bound']:.2f}x; {row['verdict']}{extra} [{card}]")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=os.path.join(
        REPO, "chiprun_out", "profile_engine_torch.json"))
    args = ap.parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("profile_engine_torch: no CUDA card (--device cpu computes "
              "the stages' work and bounds on the CPU)", file=sys.stderr)
        return 1
    from vapor_tpu_torch.engine.kernels.roofline import (HBM_BYTES_PER_S,
                                                         INT32_OPS_PER_S,
                                                         card_line)
    card = card_line() if args.device == "cuda" else None
    print(f"card: {card}; peaks {HBM_BYTES_PER_S / 1e12:.2f} TB/s, "
          f"{INT32_OPS_PER_S / 1e12:.2f} T INT32 ops/s", flush=True)
    report = {"device": args.device, "card": card, "rows_per_call": B,
              "reps": REPS, "k": K, "hbm_bytes_per_s": HBM_BYTES_PER_S,
              "int32_ops_per_s": INT32_OPS_PER_S, "buckets": {}}
    for H in BUCKETS:
        ent = profile_bucket(H, torch.device(args.device))
        report["buckets"][str(H)] = ent
        for name, row in ent["stages"].items():
            print(_line(H, name, row, card), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fo:
        json.dump(report, fo, indent=1)
    print(json.dumps({"device": args.device, "verdicts": {
        H: {n: r.get("verdict", "not measured")
            for n, r in ent["stages"].items()}
        for H, ent in report["buckets"].items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
