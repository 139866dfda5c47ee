#!/usr/bin/env python3
"""On-card smoke run of vapor_tpu_torch: builds its six dot-plot CUDA
kernels and its three glue kernels (row_codes, kept_tables,
intercept_z), holds each against its plain PyTorch version, scores a
synthetic bed
worklist (DEL, INV and tandem DUP) and a VCF worklist (DISDUP, DUP_INV
and a duplication-bearing complex event) through the CLI on the card,
and checks the output against the CPU and numpy-oracle runs.

    python3 chip_smoke.py [--seed N] [--reps N]

Phases, each fatal on failure: 1 build (nvcc's -Xptxas=-v report:
registers, shared memory, spills; the on-chip walk's dynamic shared
memory), 2 input, 3 kernel parity and timing (at each mode's event
sizes, every kernel also on dense-hit repeat rows at its reported shape,
hist by both routes, with its grid's waves, and hist's self-stats route
on the window refiner's row of the largest DUP alt hap; the glue kernels
bit for bit on the event rows and on crafted rows; at the reported
shapes also the device time apart from host work, the host time of a
wrapper call and the bound share; after phase 9, the same at every
(route, H, R) that phase 4's bed run and phase 7c's capstone run
launched, on their rows, the glue kernels' beside their plain torch-op
sequences' (the parent's path) device and host time, each kernel's
launch-weighted time over its bound in each run, and the floor split of
the on-chip walk's routes at the capstone's most-launched shape), 4 end
to end on
cuda through the default backend (cross-event batching, the device
window refiner) and through torch-nobatch, byte-equal (bed, then vcf),
5 CPU and oracle cross-check of the default backend, 6 scale-out (6a the
native BAM codec: an index-less copy of the bed worklist's BAM decodes
natively, record for record as the pure-Python decoder, and the bed CLI
on it gives phase 4's bytes; 6b the bed worklist dealt over 4 contigs
through scatter --jobs 2, a 2-rank torch.distributed (gloo) run with
both ranks on the card, and --shard-by-contig shards merged, each
byte-equal to one plain run; 6c one fused_batch's rows split over two
streams of the card, and over every visible card, bit for bit the
one-device launch), 7 accuracy and scale (7a the ten-class truth corpus,
het and homo, 4 contigs x 400 kb, through vcf --validate-vcf-tandup:
per-class results equal to ACCURACY_r5.json's, chr1's records byte-equal
to the numpy oracle's; 7b the 108 repeat-heavy haps through the device
window refiner, reaching its band QC, each window equal to the host
refiner's; 7c the capstone fixture on 4 contigs, 176 events: a pipelined
bed run, then a run killed mid-way and resumed with --resume, byte-equal
to it), 8 the goldens and the pipeline depth (8a every golden of
fixtures/golden/, bed, vcf plain and annotated, svelter and ins, on the
card through both torch backends, byte-equal to the golden, and pdf
on phase 4's smallest DUPs against the numpy oracle; 8b phase 4's
bed worklist at --pipeline 1 and 24, byte-equal to phase 4), 9 the v1
dense engine, --backend torch-v1 (9a its per-row integers on the card
equal to the CPU's in every mode, on phase 3's rows, and its ms per read
and peak memory at H = R = 16384, on random sequence and on a 2-bp
tandem repeat; 9b every golden through torch-v1, byte-equal; 9c phase
4's bed worklist through torch-v1, byte-equal to phase 4, hist launched
by its window refiner), then the list of the nine kernels,
whose launches count phases 4, 7, 8 and 9, and whose device_ms,
bound_share, lost_ms_bed / lost_ms_capstone and buckets come from phase
3 (engine/kernels/timing.py).  The last line of stdout is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Needs one CUDA card, nvcc and g++; exits non-zero without them.  Every
process it starts, and what those start, has ended when it exits.
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

SIZES = (400, 3000, 9500)     # smallest, middle and largest DEL/INV bodies
DUP_SIZES = (400, 3000, 6000)  # smallest, middle and largest DUP bodies
L2_BYTES = 50e6               # the H100's L2 cache
# where each kernel's Pallas counterpart reaches pl.pallas_call, and for
# the glue kernels the JAX function that XLA fuses into the main path
REPLACES = {
    "hist": "experiments/pallas_fused.py:268",
    "left_hist": "experiments/pallas_fused.py:420",
    "kept_hist": "experiments/pallas_fused.py:509",
    "rdd_moment": "experiments/pallas_fused.py:633",
    "moment": "experiments/pallas_fused.py:734",
    "moment2": "experiments/pallas_fused.py:851",
    "row_codes": "vapor_tpu/engine/fused.py:166",
    "kept_tables": "vapor_tpu/engine/fused.py:471",
    "intercept_z": "vapor_tpu/engine/fused.py:509",
}
# calls of a glue kernel's plain torch-op sequence whose device and host
# time phase 3 takes on the card
PLAIN_STEPS = 10
# the kernel each timed shape is reported at: the largest body, k = 10
REPORT_AT = {"hist": SIZES[-1], "left_hist": SIZES[-1],
             "moment": SIZES[-1], "moment2": SIZES[-1],
             "kept_hist": DUP_SIZES[-1], "rdd_moment": DUP_SIZES[-1]}
# and also at the smallest body, the shape of most main-path launches
SMALL_AT = {"hist": SIZES[0], "left_hist": SIZES[0], "moment": SIZES[0],
            "moment2": SIZES[0], "kept_hist": DUP_SIZES[0],
            "rdd_moment": DUP_SIZES[0]}
# (H, R) of the dense-hit repeat rows each kernel is also timed on, and
# of the grid its waves are reported for: the buckets of its reported
# shape (DEL rows pair a 12544 hap with reads cut at the left breakpoint)
REPEAT_AT = {"hist": (12544, 12544), "left_hist": (12544, 1024),
             "kept_hist": (16384, 16384), "rdd_moment": (16384, 16384),
             "moment": (12544, 12544), "moment2": (12544, 1024)}
# phase 7: the truth corpus of scripts/accuracy_corpus_torch.py at its
# defaults (ACCURACY_r5.json holds the JAX package's results on it), and
# the capstone's widths on CAPSTONE_CONTIGS of its 24 contigs
CORPUS_CONTIGS, CORPUS_LEN, CORPUS_SEED = 4, 400000, 20260821
CAPSTONE_CONTIGS = 4
# the kernels that every rdd path (vcf mode's duplications, pdf) launches
RDD_KERNELS = ("hist", "kept_hist", "rdd_moment", "row_codes", "kept_tables",
               "intercept_z")
# phase 8a: the kernels that the goldens of fixtures/golden/ launch
GOLDEN_KERNELS = ("hist", "left_hist", "moment", "moment2", "row_codes",
                  "kept_tables")
# the kernels a torch-v1 run launches: its window refiner's self-stats
# rows (row_codes, then hist's self-stats route)
V1_KERNELS = ("hist", "row_codes")
# every (kernel, route), each on csrc/walk.cuh's on-chip walk, whose
# device time at the capstone's most-launched shape phase 3 splits
# (floor_split)
FLOOR_OF = (("hist", "score"), ("hist", "selfstats"), ("left_hist", "score"),
            ("kept_hist", "score"), ("moment", "score"),
            ("moment2", "score"), ("rdd_moment", "score"))


# every process this script starts, each in a session of its own, so that
# killing its group also ends what it started (a scatter's shards)
_STARTED: list = []


def _popen(cmd, **kwargs) -> subprocess.Popen:
    proc = subprocess.Popen(cmd, start_new_session=True, **kwargs)
    _STARTED.append(proc)
    return proc


def _children() -> list:
    """The pids of this process's children, as /proc lists them."""
    me, pids = os.getpid(), []
    for d in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{d}/stat") as fh:
                ppid = int(fh.read().rsplit(")", 1)[1].split()[1])
        except (OSError, ValueError, IndexError):
            continue
        if ppid == me:
            pids.append(int(d))
    return pids


def _kill_group(proc: subprocess.Popen) -> None:
    """SIGKILLs the process and every process of its group; reaps it."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass
    proc.wait()


def _stop_all() -> None:
    """Ends every process this script started and everything those
    started, and multiprocessing's resource tracker (which phase 7b's
    worker pool starts), reaping each; then any other child that is
    left.  Nothing the script started outlives it."""
    for proc in _STARTED:
        _kill_group(proc)
    from multiprocessing import resource_tracker
    resource_tracker._resource_tracker._stop()
    for pid in _children():
        try:
            os.kill(pid, signal.SIGKILL)
            os.waitpid(pid, 0)
        except (ProcessLookupError, ChildProcessError):
            pass


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(what)


def print_ptxas(name: str, log: str) -> None:
    """One line per instance of each kernel function of a source (its
    lane count) from nvcc's -Xptxas=-v report: registers, static shared
    memory, spills."""
    for fn in log.split("Compiling entry function")[1:]:
        lanes = re.search(r"_Z\d+(\w+)_kernelILi(\d)E", fn)
        regs = re.search(r"Used (\d+) registers", fn)
        smem = re.search(r"(\d+) bytes smem", fn)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", fn)
        print(f"ptxas {lanes.group(1) if lanes else name}"
              f"<{lanes.group(2) if lanes else '?'}>: "
              f"{regs.group(1) if regs else '?'} registers, "
              f"{smem.group(1) if smem else 0} bytes smem, spill stores "
              f"{spill.group(1) if spill else '?'}, loads "
              f"{spill.group(2) if spill else '?'}", flush=True)


def tile_smem() -> None:
    """Phase 1's line for each on-chip walk route (FLOOR_OF) and lane
    count: the dynamic shared memory a block takes at the shortest and
    the tallest strip its grid plan picks (B=1, H=R=512; B=20,
    H=R=16384), and the blocks an SM then holds."""
    import torch
    from vapor_tpu_torch.engine.kernels import build
    dev = torch.cuda.current_device()
    for name, route in FLOOR_OF:
        for lanes in (2, 3, 4, 5):
            got = [build.grid_info(name, B, H, H, lanes, dev, route=route)
                   for B, H in ((1, 512), (20, 16384))]
            print(f"smem {name} {route} <{lanes}>: " + "; ".join(
                f"strip {strip}: {smem} bytes dynamic, {per_sm} blocks "
                f"per SM" for _, per_sm, _, strip, smem in got), flush=True)


# ---------------------------------------------------------------------------
# phase 3: kernel parity at the main path's shapes
# ---------------------------------------------------------------------------

def _event_rows(fa, bam, event, mode: str):
    """The rows one main-path call of `mode` gets for this event (largest
    read group): INV whole-event (m1b) rows pair the reference hap with
    reads through the whole event, DEL (del mode) rows with reads across
    the left breakpoint, tandem-DUP (rdd) rows pair the alt hap (the body
    twice, the larger of the two) with reads through s + 2 (e - s) +
    flank."""
    import numpy as np
    from vapor_tpu_torch.engine.fused import FusedBackend
    from vapor_tpu_torch.grammar.letters import flank_length_calculate
    from vapor_tpu_torch.io.fasta import FastaFile
    from vapor_tpu_torch.io.reads import collect_event_reads
    from vapor_tpu_torch.engine.constants import bucket_for
    _, s, e = event
    flank = flank_length_calculate(["chrE", s, e])
    hap = FastaFile(fa).fetch("chrE", s - flank, e + flank)
    if mode == "rdd":
        hap = hap[:flank] + 2 * hap[flank:-flank] + hap[-flank:]
    else:
        hap = hap.upper()
    end = {"m1b": e + flank, "del": s + flank,
           "rdd": s + 2 * (e - s) + flank}[mode]
    reads = collect_event_reads(bam, "chrE", s - flank, end, flank, 20)
    be = FusedBackend("cpu")
    R, idxs = max(be._read_groups(reads), key=lambda g: len(g[1]))
    H = bucket_for(len(hap) + 1)
    fw, rlens, ms = be._encode_reads([reads[i] for i in idxs], R)
    haps = np.broadcast_to(be._encode_hap(hap, H), (len(idxs), H))
    return haps, fw, rlens, ms


def _hap_lens(haps) -> list:
    """Each (H,) uint8 hap row's length: its bytes before the HAP_PAD
    tail."""
    from vapor_tpu_torch.engine.constants import HAP_PAD
    return [int(n) for n in (haps != HAP_PAD).sum(1)]


def _wrapper(name: str, route: str) -> str:
    """The wrapper that launches a kernel's route (kernels.ROUTES; a tree
    from before hist's self-stats entry point has none, and its hist
    takes the route as a keyword)."""
    from vapor_tpu_torch.engine import kernels
    return getattr(kernels, "ROUTES", {}).get((name, route), name)


def _measure(name, args, hap_lens, hits, reps, label, kwargs=None,
             timed=False, route="score"):
    """Holds one kernel's route against its plain version (every output
    integer equal) on the wrapper's arguments `args` (codes, then tables
    and flags), times the kernel call by call, host work included
    (call_ms), and the plain version's parity call (plain_ms), and prints
    one line.  With `timed`, also its device time apart from host work
    (engine/kernels/timing.py): device_ms (the C entry point, its memset
    of the outputs included, taking turns over args and the same rows
    rolled by one), host_us a wrapper call, and bound_share = bound /
    device_ms.  Returns the numbers as a dict."""
    import torch
    from vapor_tpu_torch.engine import kernels
    from vapor_tpu_torch.engine.kernels import roofline, timing
    kwargs = kwargs or {}
    wrapper = _wrapper(name, route)
    kern = functools.partial(getattr(kernels, wrapper), *args, **kwargs)
    plain = functools.partial(getattr(kernels, f"{wrapper}_plain"), *args,
                              **{x: v for x, v in kwargs.items()
                                 if x != "route"})
    got = kern()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    want = plain()
    stop.record()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(int((g.long() - w.long()).abs().max())
              for g, w in zip(got, want))
    codes = args[:6]
    B, H, R, k = (codes[0].shape[0], codes[0].shape[2], codes[1].shape[2],
                  codes[5])
    _require(err == 0, f"{name} differs from its plain version on {label} "
             f"rows, B={B}, H={H}, R={R}, k={k}: max |diff| {err}")
    out = {"max_abs_err": err, "call_ms": timing.call_ms(kern, reps),
           "plain_ms": start.elapsed_time(stop),
           "shape": f"B={B} H={H} R={R} k={k}"}
    tables = [a for a in args[6:] if isinstance(a, torch.Tensor)]
    out["bound_ms"], out["bound_by"] = roofline.bound(*roofline.kernel_work(
        wrapper, codes, hap_lens, got, tables, hits))
    line = (f"parity {name:10s} {label} B={B:2d} H={H:5d} R={R:5d} k={k}: "
            f"equal; kernel {out['call_ms']:.4f} ms, plain "
            f"{out['plain_ms']:.3f} ms, bound {out['bound_ms']:.4f} ms, "
            f"{hits} hits")
    if timed:
        second = functools.partial(getattr(kernels, wrapper),
                                   *timing.rolled(args), **kwargs)
        out["device_ms"] = timing.device_ms([kern, second])
        out["host_us"] = timing.host_us([kern, second])
        out["bound_share"] = out["bound_ms"] / out["device_ms"]
        both = 2 * roofline.tensor_bytes(
            [a for a in args if isinstance(a, torch.Tensor)] + list(got))
        out["l2"] = "warm" if both <= L2_BYTES else "spills"
        line += (f"; device {out['device_ms']:.4f} ms, host "
                 f"{out['host_us']:.1f} us a call, bound share "
                 f"{out['bound_share']:.3f}, L2 "
                 f"{out['l2']} ({both / 1e6:.1f} MB in two batches)")
    print(line, flush=True)
    return out


def _compare(name, body, k, args, hap_lens, hits, reps, report):
    """_measure on the rows of one event; keeps the numbers of the
    reported shape (device time too), and the kernel's call time at the
    smallest body."""
    at = body == REPORT_AT[name] and k == 10
    got = _measure(name, args, hap_lens, hits, reps, f"body {body}",
                   timed=at)
    entry = report.setdefault(name, {"max_abs_err": 0})
    entry["max_abs_err"] = max(entry["max_abs_err"], got["max_abs_err"])
    if at:
        entry.update({x: v for x, v in got.items() if x != "max_abs_err"},
                     ms=got["call_ms"])
    if body == SMALL_AT[name] and k == 10:
        entry.update(small_ms=got["call_ms"], small_shape=got["shape"])


def _glue_work(name, args, kwargs, got):
    """(bytes, operations) of one glue wrapper call (engine/kernels/
    roofline.py)."""
    from vapor_tpu_torch.engine.kernels import roofline
    if name == "row_codes":
        hap_index = args[4] if len(args) > 4 else kwargs.get("hap_index")
        return roofline.codes_work(*args[:3], got, args[3], hap_index)
    if name == "kept_tables":
        return roofline.kept_tables_work(args[0], got)
    return roofline.intercept_work(args[0], got)


def _glue_measure(name, args, reps, label, report, kwargs=None,
                  timed=False):
    """Holds one glue kernel against its plain version (every output
    element equal: the kernel's bits are the torch ops') on the wrapper's
    arguments, times the kernel call by call (call_ms) and the plain
    version's call (plain_ms), and adds its error to report[name].  With
    `timed`, also the device time apart from host work (taking turns
    over args and the same rows rolled by one), the host µs of a wrapper
    call and the bound share, and the device ms and host µs of the plain
    torch-op sequence on the card, which is what the main path ran
    before the kernel (plain_device_ms: its ops' device time under
    torch.profiler, timing.busy_ms: a spin window does not hold its host
    work; plain_host_us).  Returns the numbers as a dict."""
    import torch
    from vapor_tpu_torch.engine import kernels
    from vapor_tpu_torch.engine.kernels import roofline, timing
    kwargs = kwargs or {}
    kern = functools.partial(getattr(kernels, name), *args, **kwargs)
    plain = functools.partial(getattr(kernels, f"{name}_plain"), *args,
                              **kwargs)
    got = kern()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    want = plain()
    stop.record()
    torch.cuda.synchronize()
    _require(len(got) == len(want) and all(
        g.dtype == w.dtype and g.shape == w.shape for g, w in zip(got, want)),
        f"{name} on {label}: outputs of another type or shape than its "
        f"plain version's")
    err = max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
              for g, w in zip(got, want))
    _require(err == 0, f"{name} differs from its plain version on {label}: "
             f"max |diff| {err}")
    entry = report.setdefault(name, {"max_abs_err": 0})
    entry["max_abs_err"] = max(entry["max_abs_err"], err)
    out = {"max_abs_err": err, "call_ms": timing.call_ms(kern, reps),
           "plain_ms": start.elapsed_time(stop)}
    out["bound_ms"], out["bound_by"] = roofline.bound(
        *_glue_work(name, args, kwargs, got))
    line = (f"parity {name:11s} {label}: equal; kernel "
            f"{out['call_ms']:.4f} ms, plain {out['plain_ms']:.3f} ms, "
            f"bound {out['bound_ms']:.4f} ms")
    if timed:
        second = timing.rolled(args)
        calls = [kern, functools.partial(getattr(kernels, name), *second,
                                         **kwargs)]
        plains = [plain, functools.partial(getattr(kernels, f"{name}_plain"),
                                           *second, **kwargs)]
        out["device_ms"] = timing.device_ms(calls)
        out["host_us"] = timing.host_us(calls)
        out["bound_share"] = out["bound_ms"] / out["device_ms"]
        out["plain_device_ms"] = timing.busy_ms(plains, PLAIN_STEPS)
        out["plain_host_us"] = timing.host_us(plains, PLAIN_STEPS)
        line += (f"; device {out['device_ms']:.4f} ms, host "
                 f"{out['host_us']:.1f} us a call, bound share "
                 f"{out['bound_share']:.3f}; torch ops (the parent's path) "
                 f"device {out['plain_device_ms']:.4f} ms, host "
                 f"{out['plain_host_us']:.1f} us")
    print(line, flush=True)
    return out


def _glue_tables(hs, specs, H, R, label, reps, report):
    """kept_tables of an (H, R) batch's histograms on the card, held
    against its plain version; the tables."""
    from vapor_tpu_torch.engine import kernels
    args = (tuple(hs), tuple(specs), H, R)
    _glue_measure("kept_tables", args, reps, label, report)
    return kernels.kept_tables(*args)


def _shape(codes):
    """The (H, R) of a batch's codes (ch, cf, ...)."""
    return codes[0].shape[2], codes[1].shape[2]


def kernel_parity(fa, bam, events, reps: int):
    """Each kernel against its plain version at the smallest, middle and
    largest event sizes of its mode, k = 10 and 40; every output integer
    must be equal.  Returns {name: stats at the largest size, k = 10}."""
    import torch
    from vapor_tpu_torch.engine import kernels
    from vapor_tpu_torch.engine.fused import (batch_from_numpy, intercept_z,
                                              row_codes)
    dev = torch.device("cuda")
    report = {}

    def rows(ev, mode, k):
        haps, fw, rlens, ms = _event_rows(fa, bam, ev, mode)
        h, r, rl, m, _ = batch_from_numpy(haps, fw, rlens, ms,
                                          k // 10 - 1, dev)
        label = f"{ev[0]} body {ev[2] - ev[1]} ({mode} rows) k={k}"
        # the rows' one hap, as the batching backend uploads it
        index = torch.zeros(r.shape[0], dtype=torch.int64, device=dev)
        _glue_measure("row_codes", (h[:1].contiguous(), r, rl, k, index),
                      reps, label, report)
        codes = (*row_codes(h, r, rl, k), m, rl, k)
        h_d, h_a, scal = kernels.hist_plain(*codes)
        kd, ka = _glue_tables((h_d, h_a), ((10, False), (10, False)),
                              *_shape(codes), label, reps, report)
        return codes, _hap_lens(haps), int(scal[:, :2].sum()), h_d, kd, ka

    def find(svtype, body):
        return next(ev for ev in events if ev[0] == svtype and
                    ev[2] - ev[1] == body)

    for body in SIZES:
        for k in (10, 40):
            codes_i, n_i, hits_i, _, kd_i, ka_i = rows(find("INV", body),
                                                       "m1b", k)
            codes_d, n_d, hits_d, h_d, kd_d, ka_d = rows(find("DEL", body),
                                                         "del", k)
            kd50, = _glue_tables((h_d,), ((50, True),), *_shape(codes_d),
                                 f"DEL {body} k={k}", reps, report)
            ka50, = _glue_tables((kernels.left_hist_plain(*codes_d, kd50),),
                                 ((50, True),), *_shape(codes_d),
                                 f"DEL {body} k={k} left", reps, report)
            runs = {
                "hist": (codes_i, n_i, hits_i),
                "moment": ((*codes_i, kd_i, ka_i, False), n_i, hits_i),
                "left_hist": ((*codes_d, kd50), n_d, hits_d),
                "moment2": ((*codes_d, kd_d, ka_d, kd50, ka50), n_d,
                            hits_d),
            }
            for name, run in runs.items():
                _compare(name, body, k, *run, reps, report)
            # moment's w10 call (fused_batch's w10 mode) on the same rows
            # with the 50-threshold tables: held equal, its time printed
            # beside the reported m1b call's
            err = _measure("moment", (*codes_d, kd50, ka50, True), n_d,
                           hits_d, reps, f"body {body} w10")["max_abs_err"]
            report["moment"]["max_abs_err"] = max(
                report["moment"]["max_abs_err"], err)
    for body in DUP_SIZES:
        for k in (10, 40):
            codes, lens, hits, _, kd, ka = rows(find("DUP", body), "rdd",
                                                k)
            h_kept = kernels.kept_hist_plain(*codes, kd, ka)
            _glue_measure("intercept_z", (h_kept, *_shape(codes)), reps,
                          f"DUP {body} k={k}", report)
            found, z = intercept_z(h_kept, *_shape(codes))
            z = torch.where(found, z + 2 * codes[3], 0).to(torch.int32)
            print(f"intercepts at DUP body {body}, k={k}: "
                  f"{int(found.sum())} of {found.numel()} rows",
                  flush=True)
            _compare("kept_hist", body, k, (*codes, kd, ka), lens, hits,
                     reps, report)
            _compare("rdd_moment", body, k, (*codes, kd, ka, z), lens, hits,
                     reps, report)
    return report


def _crafted_hist(name: str):
    """(W, H, histogram) rows for the intercept fit's branches (the cases
    of tests/test_torch_fused.py)."""
    import numpy as np
    W, H = 640, 256
    h = np.zeros(W, np.int32)
    if name == "one_value":          # hi == lo: every value in bin 10
        h[300] = 7
    elif name == "one_bin":          # one first-level bin wins outright
        h[[100, 420]] = 1
        h[250:256] = [3, 1, 4, 1, 5, 9]
    elif name == "sub_hi_eq_lo":     # the winning bin holds one value
        h[[100, 300, 420]] = [2, 9, 2]
    elif name == "two_way_tie":      # two first-level bins, equal totals
        h[[100, 101, 420]] = [3, 2, 5]
    elif name == "sub_tie":          # one winning bin, its sub-bins tie
        h[[100, 420]] = 1
        h[[250, 259]] = 6
    elif name == "even_median":      # ranks n/2 and n/2 + 1 differ
        h[[10, 630]] = 1
        h[[286, 292, 293, 306]] = [1, 2, 2, 1]
    elif name == "negative_values":  # values v = bin - H below zero
        h[[20, 40, 41, 42, 200]] = [1, 5, 6, 2, 1]
    return W, H, h


CRAFTED = ("empty", "one_value", "one_bin", "sub_hi_eq_lo", "two_way_tie",
           "sub_tie", "even_median", "negative_values")


def glue_crafted(seed: int, reps: int, report) -> None:
    """The glue kernels against their plain versions on crafted rows:
    row_codes on every byte of the engine's alphabet, rows with rlen 0,
    rlen < k and rlen = R, fused_batch's pad rows (HAP_PAD hap, READ_PAD
    read, rlen 1) and an index-expanded hap, at k = 10..40 (every
    column, the ones past rlen - k included); kept_tables on all-zero
    rows, one bin, a cluster that runs to the last bin, clusters gap - 1
    and gap apart, a fallback tie of two largest clusters, and random
    sparse rows at the largest width, four tables in one launch; and
    intercept_z on found, tied and empty rows (CRAFTED) and a batch of
    all of them."""
    import numpy as np
    import torch
    from vapor_tpu_torch.engine.constants import (HAP_PAD, READ_PAD,
                                                  hist_width)
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGTNacgtnXx=", np.uint8)
    H, R, B = 512, 384, 8
    haps = alphabet[rng.integers(0, alphabet.size, (B, H))]
    reads = alphabet[rng.integers(0, alphabet.size, (B, R))]
    rlens = rng.integers(50, R, B).astype(np.int32)
    rlens[:4] = [0, 7, R, 1]
    haps[3], reads[3] = HAP_PAD, READ_PAD        # a pad row
    haps[4, H - 100:] = HAP_PAD
    for b in range(B):
        reads[b, max(rlens[b], 0):] = READ_PAD
    h, r, rl = (torch.from_numpy(x).to(dev) for x in (haps, reads, rlens))
    index = torch.from_numpy(rng.integers(0, 3, B)).to(dev)
    for k in (10, 20, 30, 40):
        _glue_measure("row_codes", (h, r, rl, k), reps,
                      f"crafted rows k={k}", report)
        _glue_measure("row_codes", (h[:3].contiguous(), r, rl, k, index),
                      reps, f"crafted rows, hap_index, k={k}", report)

    W = 640
    rows = np.zeros((8, W), np.int32)
    rows[1, 321] = 4                                  # one bin
    rows[2, [600, 610, 620, 639]] = [3, 1, 2, 9]      # to the last bin
    rows[3, [100, 109, 200, 210]] = [30, 30, 30, 30]  # gap - 1 and gap
    rows[4, [50, 300]] = [20, 20]                     # a fallback tie
    for b in range(5, 8):
        idx = rng.integers(0, W, 40 * b)
        np.add.at(rows[b], idx, rng.integers(1, 30, idx.size))
    hs = [torch.from_numpy(np.roll(rows, t, 0)).to(dev) for t in range(4)]
    for specs in (((10, False),), ((50, True),),
                  ((10, False), (50, True), (10 ** 6, True), (0, False))):
        _glue_tables(hs[:len(specs)], specs, 256, 256, f"crafted rows "
                     f"W={W} {specs}", reps, report)
    W = hist_width(16384, 16384)
    big = np.zeros((4, W), np.int32)
    for b in range(4):
        idx = rng.integers(0, W, 2000 * (b + 1))
        np.add.at(big[b], idx, rng.integers(1, 5, idx.size))
    big[0] = 0
    big[1, W - 1] = 70
    t = torch.from_numpy(big).to(dev)
    _glue_tables((t, t, t), ((10, False), (50, True), (3, True)), 16384,
                 16384, f"sparse rows W={W}", reps, report)

    crafted = np.stack([_crafted_hist(n)[2] for n in CRAFTED])
    for n, row in zip(CRAFTED, crafted):
        _glue_measure("intercept_z", (torch.from_numpy(row[None]).to(dev),
                                      256, 256), reps, f"crafted {n}",
                      report)
    _glue_measure("intercept_z", (torch.from_numpy(crafted).to(dev), 256,
                                  256), reps, "the crafted rows as one batch",
                  report)
    _glue_measure("intercept_z", (t, 16384, 16384), reps,
                  f"sparse rows W={W}", report)


def repeat_parity(seed: int, reps: int, report) -> None:
    """Each kernel against its plain version on dense-hit rows
    (sim/worklists.py repeat_rows: a third of every hap and read is one 6 bp
    unit repeated) at B=20, (H, R) = its reported shape, k=10, with the
    tables its mode gives it: the m1b tables (kept_hist, rdd_moment, and
    moment without w10, as mode m1b calls it), the 50-threshold d-table
    (left_hist) and both sets (moment2, as mode del calls it); adds the
    kernel's time there to its report.  A kernel without a grid query
    (one not on csrc/walk.cuh, in an older tree) is skipped."""
    import torch
    from vapor_tpu_torch.engine import kernels
    from vapor_tpu_torch.engine.fused import (batch_from_numpy, intercept_z,
                                              kept_table, row_codes)
    from vapor_tpu_torch.engine.kernels import build
    from vapor_tpu_torch.sim.worklists import repeat_rows
    k = 10
    for name, (H, R) in REPEAT_AT.items():
        if name not in build.GRID_POINTS:
            continue
        batch = repeat_rows(H, R, 20, seed, ms=(0, 23))
        h, r, rl, m, _ = batch_from_numpy(*batch, k // 10 - 1,
                                          torch.device("cuda"))
        codes = (*row_codes(h, r, rl, k), m, rl, k)
        h_d, h_a, scal = kernels.hist_plain(*codes)
        hits = int(scal[:, :2].sum())
        kd, ka = (kept_table(x, 10, 10, False, H, R) for x in (h_d, h_a))
        kd50 = kept_table(h_d, 10, 50, True, H, R)
        if name == "hist":
            args = ()
        elif name == "left_hist":
            args = (kd50,)
        elif name == "kept_hist":
            args = (kd, ka)
        elif name == "moment":
            args = (kd, ka, False)
        elif name == "moment2":
            ka50 = kept_table(kernels.left_hist_plain(*codes, kd50), 10, 50,
                              True, H, R)
            args = (kd, ka, kd50, ka50)
        else:
            found, z = intercept_z(kernels.kept_hist_plain(*codes, kd, ka),
                                   H, R)
            args = (kd, ka, torch.where(found, z + 2 * m, 0).to(torch.int32))
        got = _measure(name, (*codes, *args), _hap_lens(batch[0]), hits,
                       reps, "repeat")
        report[name].update(
            max_abs_err=max(report[name]["max_abs_err"], got["max_abs_err"]),
            repeat_ms=got["call_ms"], repeat_bound_ms=got["bound_ms"])
        if name == "hist" and hasattr(kernels, "hist_self"):
            # the self-stats route reduces the same walk's hits
            got = _measure(name, codes, _hap_lens(batch[0]), hits, reps,
                           "repeat", route="selfstats")
            report[name]["max_abs_err"] = max(report[name]["max_abs_err"],
                                              got["max_abs_err"])


def walk_waves(report) -> None:
    """Prints the grid of each kernel with a grid query (csrc/walk.cuh's
    kernels) at its reported shape, B=20, k=10, and its waves: blocks
    over the blocks the card holds at once."""
    import torch
    from vapor_tpu_torch.engine.kernels import build
    for name in build.GRID_POINTS:
        H, R = REPEAT_AT[name]
        blocks, per_sm, sms, strip, smem = build.grid_info(
            name, 20, H, R, 2, torch.cuda.current_device())
        waves = blocks / (per_sm * sms)
        print(f"grid {name}: H={H} R={R}: {blocks} blocks of {strip} hap "
              f"rows, {per_sm} resident per SM x {sms} SMs: {waves:.2f} "
              f"waves; {smem} bytes of dynamic shared memory a block",
              flush=True)
        report[name]["waves"] = waves


def selfstats_parity(fa, events, reps: int, report) -> None:
    """hist on the window refiner's self-stats row (the hap as its own
    read: m = 0, rlen = length, H = R) at the refiner's largest shape: the
    bed worklist's largest DUP alt hap (the body twice, 13 kb), H = R =
    16384, k = 10 and 40; adds the k = 10 numbers to hist's report."""
    import numpy as np
    import torch
    from vapor_tpu_torch.engine import kernels, oracle
    from vapor_tpu_torch.engine.constants import HAP_PAD, READ_PAD, bucket_for
    from vapor_tpu_torch.engine.fused import row_codes
    from vapor_tpu_torch.grammar.letters import flank_length_calculate
    from vapor_tpu_torch.io.fasta import FastaFile
    _, s, e = next(ev for ev in events if ev[0] == "DUP" and
                   ev[2] - ev[1] == DUP_SIZES[-1])
    flank = flank_length_calculate(["chrE", s, e])
    hap = FastaFile(fa).fetch("chrE", s - flank, e + flank)
    codes = oracle.encode(hap[:flank] + 2 * hap[flank:-flank] + hap[-flank:])
    H = bucket_for(len(codes) + 1)
    row = np.full((1, H), HAP_PAD, np.uint8)
    row[0, :len(codes)] = codes
    dev = torch.device("cuda")
    h = torch.from_numpy(row).to(dev)
    n = torch.tensor([len(codes)], dtype=torch.int32, device=dev)
    reads = torch.where(torch.arange(H, device=dev) < n[:, None].long(), h,
                        torch.full_like(h, READ_PAD))
    for k in (10, 40):
        c = (*row_codes(h, reads, n, k), torch.zeros_like(n), n, k)
        hits = int(kernels.hist_plain(*c)[2][:, :2].sum())
        got = _measure("hist", c, [len(codes)], hits, reps,
                       f"self-stats length {len(codes)}", timed=k == 10,
                       route="selfstats")
        report["hist"]["max_abs_err"] = max(report["hist"]["max_abs_err"],
                                            got["max_abs_err"])
        if k == 10:
            shape = f"B=1 H=R={H} length={len(codes)} k={k}"
            report["hist"].update(
                selfstats_ms=got["call_ms"],
                selfstats_plain_ms=got["plain_ms"],
                selfstats_bound_ms=got["bound_ms"], selfstats_shape=shape)
            report["hist"]["selfstats"] = {
                x: got[x] for x in ("device_ms", "call_ms", "host_us",
                                    "bound_ms", "bound_by", "bound_share",
                                    "l2")}
            report["hist"]["selfstats"]["shape"] = shape


def bucket_parity(runs, reps: int, report) -> None:
    """Phase 3 at the main path's buckets, once phases 4 and 7c have run:
    each kernel at every (route, H, R) that the bed worklist's run
    (runs["bed"]) or the capstone's (runs["capstone"]) launched it at, on
    the rows of that run's first call there (the bed run's where both
    launched it), cut to B=20 (B=1 for hist's self-stats rows): held
    equal to its plain version, its device time apart from host work,
    call time, host time and bound (_measure).  Then each kernel's
    launch-weighted time over its bound in each run (roofline.lost_ms),
    and its launch-weighted bound share, sum(launches x bound) /
    sum(launches x device ms)."""
    import torch
    from vapor_tpu_torch.engine import kernels
    from vapor_tpu_torch.engine.kernels import build, roofline, timing
    device, bound = {}, {}
    for key in sorted(x for x in set(runs["bed"].shapes) |
                      set(runs["capstone"].shapes) if x[1] != "glue"):
        name, route, H, R = key
        src = "bed" if key in runs["bed"].shapes else "capstone"
        _require(key in runs[src].args, f"{key}: launched in the {src} run "
                 f"but no call recorded")
        args, kwargs = runs[src].args[key]
        args = timing.tile_rows(args, 1 if route == "selfstats" else 20)
        hits = int(kernels.hist(*args[:6])[2][:, :2].sum())
        n = {x: runs[x].shapes.get(key, 0) for x in runs}
        got = _measure(name, args, timing.hap_lens(args[0], args[5]), hits,
                       reps, f"{route} bucket ({src} rows; launches bed "
                       f"{n['bed']}, capstone {n['capstone']})", kwargs,
                       timed=True, route=route)
        device[key], bound[key] = got["device_ms"], got["bound_ms"]
        B = args[0].shape[0]
        blocks, per_sm, sms = build.grid_info(
            name, B, H, R, args[0].shape[1], torch.cuda.current_device(),
            route=route)[:3]
        entry = report[name]
        entry["max_abs_err"] = max(entry["max_abs_err"], got["max_abs_err"])
        entry.setdefault("buckets", []).append({
            "route": route, "H": H, "R": R, "B": B, "k": args[5],
            "rows": src, "launches_bed": n["bed"],
            "launches_capstone": n["capstone"],
            "waves": blocks / (per_sm * sms),
            **{x: got[x] for x in ("device_ms", "call_ms", "host_us",
                                   "bound_ms", "bound_by", "bound_share",
                                   "plain_ms", "l2")}})
    for src, run in runs.items():
        lost = roofline.lost_ms({x: n for x, n in run.shapes.items()
                                 if x[1] != "glue"}, device, bound)
        for name, route in [(x, "score") for x in kernels.NAMES] + \
                [("hist", "selfstats")]:
            keys = [x for x in run.shapes if x[:2] == (name, route)]
            _require(keys, f"the {src} run never launched {name} ({route})")
            share = sum(run.shapes[x] * bound[x] for x in keys) / sum(
                run.shapes[x] * device[x] for x in keys)
            entry = report[name] if route == "score" \
                else report[name]["selfstats"]
            entry[f"lost_ms_{src}"] = lost[name, route]
            entry[f"bound_share_{src}"] = share
            print(f"phase 3 buckets {name} {route}: {src} run, "
                  f"{sum(run.shapes[x] for x in keys)} launches at "
                  f"{len(keys)} shapes, {lost[name, route]:.3f} ms over the "
                  f"bound, launch-weighted bound share {share:.3f}",
                  flush=True)
    print(f"phase 3 buckets: {len(device)} shapes, each equal to its plain "
          f"version", flush=True)


def _rows_of(name: str, args) -> int:
    """The batch rows of a glue wrapper's call."""
    return (args[1] if name == "row_codes" else
            args[0][0] if name == "kept_tables" else args[0]).shape[0]


def glue_bucket_parity(runs, reps: int, report) -> None:
    """The glue kernels at every (H, R) that the bed worklist's run or the
    capstone's launched them at, on the arguments of each run's own first
    call there (a shape both runs launched is measured on each run's
    rows: the two runs' batches differ in rows), as the main path made
    them: held equal to the plain version, the device time apart from
    host work, host µs, bound and bound share, and the plain torch-op
    sequence's device ms and host µs on the card (_glue_measure).  Then
    each glue kernel's launch-weighted time over its bound in each run
    (roofline.lost_ms), its launch-weighted bound share, and the
    launch-weighted device ms of the kernel and of the torch ops, each
    run weighted by the times on its own rows.  The kernel's headline
    numbers are those of the capstone's most-launched shape, on the
    capstone's rows."""
    from vapor_tpu_torch.engine import kernels
    from vapor_tpu_torch.engine.kernels import roofline
    for src, run in runs.items():
        device, bound, plain = {}, {}, {}
        shapes = {x: n for x, n in run.shapes.items() if x[1] == "glue"}
        for key in sorted(shapes):
            name, _, H, R = key
            _require(key in run.args, f"{key}: launched in the {src} run "
                     f"but no call recorded")
            args, kwargs = run.args[key]
            B = _rows_of(name, args)
            got = _glue_measure(name, args, reps, f"glue bucket H={H} R={R} "
                                f"B={B} ({src} rows; {shapes[key]} "
                                f"launches)", report, kwargs, timed=True)
            device[key], bound[key] = got["device_ms"], got["bound_ms"]
            plain[key] = got["plain_device_ms"]
            report[name].setdefault("buckets", []).append({
                "route": "glue", "H": H, "R": R, "B": B, "rows": src,
                "launches": shapes[key],
                **{x: got[x] for x in ("device_ms", "call_ms", "host_us",
                                       "bound_ms", "bound_by",
                                       "bound_share", "plain_ms",
                                       "plain_device_ms",
                                       "plain_host_us")}})
        lost = roofline.lost_ms(shapes, device, bound)
        for name in kernels.GLUE_NAMES:
            keys = [x for x in shapes if x[0] == name]
            _require(keys, f"the {src} run never launched {name}")
            entry = report[name]
            entry[f"lost_ms_{src}"] = lost[name, "glue"]
            entry[f"bound_share_{src}"] = sum(
                shapes[x] * bound[x] for x in keys) / sum(
                shapes[x] * device[x] for x in keys)
            entry[f"device_ms_{src}"] = sum(shapes[x] * device[x]
                                            for x in keys)
            entry[f"plain_device_ms_{src}"] = sum(shapes[x] * plain[x]
                                                  for x in keys)
            print(f"phase 3 glue buckets {name}: {src} run, "
                  f"{sum(shapes[x] for x in keys)} launches at {len(keys)} "
                  f"shapes, kernel {entry[f'device_ms_{src}']:.3f} ms of "
                  f"device time ({entry[f'lost_ms_{src}']:.3f} ms over the "
                  f"bound, launch-weighted bound share "
                  f"{entry[f'bound_share_{src}']:.3f}); the torch ops "
                  f"{entry[f'plain_device_ms_{src}']:.3f} ms", flush=True)
    for name in kernels.GLUE_NAMES:
        entry = report[name]
        top = max((x for x in entry["buckets"] if x["rows"] == "capstone"),
                  key=lambda x: (x["launches"], x["H"], x["R"]))
        entry.update({x: top[x] for x in (
            "device_ms", "call_ms", "host_us", "bound_ms", "bound_by",
            "bound_share", "plain_ms", "plain_device_ms", "plain_host_us")},
            ms=top["call_ms"],
            shape=f"B={top['B']} H={top['H']} R={top['R']} (the capstone's "
                  f"most-launched shape, its rows)")
    print(f"phase 3 glue buckets: "
          f"{sum(len(report[x]['buckets']) for x in kernels.GLUE_NAMES)} "
          f"(shape, run) pairs, each equal to its plain version",
          flush=True)


def floor_split(runs, report) -> None:
    """Where a launch's device time goes at the capstone's most-launched
    shape of each route in FLOOR_OF, on that shape's rows (B=20; B=1 for
    self-stats rows), from engine/kernels/timing.py windows (two batches,
    the rows and the rows rolled by one): `path` the device work of whole
    wrapper calls as the main path issues them, `entry` the C entry point
    alone (timing.device_ms), `empty` the entry point on rows with no
    eligible cell (rlens 0: every block exits at once) and `nohit` on
    read codes drawn at random (next to no rare path).  The split:
    launch = empty (with the entry point's memset of the outputs),
    staging and fast path = nohit - empty (staging, zeroing, the fast
    path, the flush scan, the tail wave), rare path = entry - nohit (the
    candidates' lanes, the visitors, the flush of the bins they filled),
    fill = path - entry (device work of a wrapper call beyond its entry
    point: a fill op, where a wrapper issued one)."""
    import torch
    from vapor_tpu_torch.engine import kernels
    from vapor_tpu_torch.engine.kernels import timing
    gen = torch.Generator(device="cuda").manual_seed(12)
    shapes = runs["capstone"].shapes
    for name, route in FLOOR_OF:
        key = max((x for x in shapes if x[:2] == (name, route)),
                  key=lambda x: (shapes[x], x))
        args, kwargs = runs["capstone"].args[key]
        args = timing.tile_rows(args, 1 if route == "selfstats" else 20)
        fn = getattr(kernels, _wrapper(name, route))

        def calls(a):
            return [functools.partial(fn, *a, **kwargs),
                    functools.partial(fn, *timing.rolled(a), **kwargs)]

        def entry(a):
            return timing.device_ms(calls(a))

        nohit, empty = list(args), list(args)
        for x in (1, 2):
            nohit[x] = torch.randint(-2 ** 31, 2 ** 31 - 1, args[x].shape,
                                     generator=gen, device="cuda",
                                     dtype=torch.int32)
        empty[4] = torch.zeros_like(args[4])
        got = {"path": timing._window_ms(calls(args), 50),
               "entry": entry(args), "nohit": entry(nohit),
               "empty": entry(empty)}
        split = {"H": key[2], "R": key[3], "B": args[0].shape[0],
                 "launches_capstone": shapes[key],
                 "path_ms": got["path"], "fill_ms": got["path"] - got["entry"],
                 "launch_ms": got["empty"],
                 "staging_ms": got["nohit"] - got["empty"],
                 "rare_ms": got["entry"] - got["nohit"]}
        print(f"phase 3 floor split {name} {route} B={split['B']} H={key[2]} "
              f"R={key[3]} ({shapes[key]} capstone launches): device "
              f"{got['path']:.4f} ms a call = fill {split['fill_ms']:.4f} + "
              f"launch {split['launch_ms']:.4f} + staging and fast path "
              f"{split['staging_ms']:.4f} + rare path "
              f"{split['rare_ms']:.4f}", flush=True)
        (report[name] if route == "score"
         else report[name]["selfstats"])["floor"] = split


# ---------------------------------------------------------------------------
# phases 4-5: the CLI
# ---------------------------------------------------------------------------

def run_cli(mode, fa, bam, sv_input, out=None, backend="torch",
            device="cuda", extra=()):
    """One CLI run; returns the output's lines without header lines (the
    bed rows, or the annotated VCF records, which vcf mode writes to
    <sv-input>.vapor)."""
    from vapor_tpu_torch.cli import main
    args = [mode, "--sv-input", sv_input, "--reference", fa,
            "--pacbio-input", bam, "--output-path",
            os.path.join(os.path.dirname(sv_input), "figs"),
            "--backend", backend, "--device", device, "--no-figures",
            *extra]
    if out:
        args += ["--output-file", out]
    rc = main(args)
    _require(rc == 0, f"{mode} CLI ({backend}, {device}) exited {rc}")
    with open(out or sv_input + ".vapor") as fh:
        return [line for line in fh.read().splitlines()
                if not line.startswith("#")]


def _copy_lines(src: str, dst: str, keep) -> str:
    """Copies the lines of src whose index i has keep(i) to dst."""
    with open(src) as fh, open(dst, "w") as fo:
        fo.writelines(x for i, x in enumerate(fh) if keep(i))
    return dst


class MainPath:
    """What one main-path run launched: kernels.LAUNCH_SHAPES' counts
    after it (`shapes`), and the arguments of each (name, route, H, R)
    key's first call (`args`, engine/kernels/timing.py capture)."""

    def __init__(self):
        self.shapes: dict = {}
        self.args: dict = {}


def _timed_run(label, counted, *cli_args, record=None, **cli_kw):
    """Drives one main path on the card with every count set to 0 just
    before it; checks the kernels of that path launched, the refiner's
    self-stats rounds went through hist, and no plain version ran on
    CUDA tensors.  Prints the window refiner's tallies and the launches
    by H x R, hist's self-stats launches apart.  With `record` (a
    MainPath), keeps the run's launch shapes and first calls there.
    Returns (rows, seconds, launches)."""
    import contextlib
    import torch
    from vapor_tpu_torch.engine import kernels, window_device
    from vapor_tpu_torch.engine.kernels import timing
    kernels.reset_counts()
    band0 = dict(window_device.BAND_STATS)
    t0 = time.perf_counter()
    with timing.capture(record.args) if record is not None \
            else contextlib.nullcontext():
        rows = run_cli(*cli_args, **cli_kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    plain_on_cuda = dict(kernels.PLAIN_CUDA_CALLS)
    shapes = dict(kernels.LAUNCH_SHAPES)
    if record is not None:
        record.shapes = shapes
    band = {x: window_device.BAND_STATS[x] - band0[x] for x in band0}
    refiner = {H: n for (_, route, H, _), n in sorted(shapes.items())
               if route == "selfstats"}
    _require(all(launches[n] > 0 for n in counted),
             f"{label}: a kernel of the path never launched: {launches}")
    _require(not any(plain_on_cuda.values()),
             f"{label}: plain versions ran on CUDA tensors: "
             f"{plain_on_cuda}")
    _require(band["stat_rounds"] > 0 and
             0 < sum(refiner.values()) <= band["stat_rounds"],
             f"{label}: {band['stat_rounds']} refiner rounds in "
             f"{sum(refiner.values())} self-stats launches")
    print(f"{label} window refiner: {band}; self-stats launches of hist by "
          f"H = R: {refiner}", flush=True)
    for name in kernels.ALL_NAMES:
        by = ", ".join(f"{H}x{R}: {n}" for (x, route, H, R), n
                       in sorted(shapes.items())
                       if x == name and route in ("score", "glue"))
        if by:
            kind = "glue" if name in kernels.GLUE_NAMES else "score"
            print(f"{label} {kind} launches of {name} by H x R: {by}",
                  flush=True)
    return rows, wall, launches


# ---------------------------------------------------------------------------
# phase 6: scale-out
# ---------------------------------------------------------------------------

def _read_bytes(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def codec_phase(tmp, fa, bam, bed, events, rows, wall) -> None:
    """6a: an index-less copy of the bed worklist's BAM goes through
    BamReader, which must decode with the native codec, every event
    region's records equal to the pure-Python decode, and the bed CLI on
    it must give phase 4's rows."""
    from vapor_tpu_torch import native
    from vapor_tpu_torch.engine import kernels
    from vapor_tpu_torch.io.bam import BamReader
    from vapor_tpu_torch.io.reads import _open_bam
    d = os.path.join(tmp, "nobai")
    os.makedirs(d)
    plain_bam = shutil.copyfile(bam, os.path.join(d, "reads.bam"))
    reader = _open_bam(plain_bam)
    _require(isinstance(reader, BamReader) and reader.decoder == "native",
             f"index-less BAM: {type(reader).__name__} decoded by "
             f"{getattr(reader, 'decoder', '?')}; codec: "
             f"{native.LOAD_ERROR}")
    python = BamReader(plain_bam, native=False)
    n_records = 0
    for _, s, e in events:
        region = ("chrE", max(1, s - 2000), e + 2000)
        got = [(r.name, r.flag, r.pos0, r.mapq, r.cigar, r.seq)
               for r in reader.fetch(*region)]
        want = [(r.name, r.flag, r.pos0, r.mapq, r.cigar, r.seq)
                for r in python.fetch(*region)]
        _require(got == want, f"native and Python decodes differ on "
                 f"{region}")
        n_records += len(got)
    _require(n_records > 0, "no records in the event regions")
    got, nb_wall, launches = _timed_run(
        "bed index-less", kernels.ALL_NAMES, "bed", fa, plain_bam, bed,
        os.path.join(d, "out.vapor"))
    _require(got == rows, "bed on the index-less BAM differs from phase 4")
    print(f"phase 6a codec: native decode of the index-less BAM, "
          f"{n_records} records in {len(events)} event regions equal the "
          f"Python decode; bed equal to phase 4: index-less "
          f"{nb_wall:.2f} s, {len(events) / nb_wall:.2f} events/s, "
          f"indexed (phase 4) {wall:.2f} s, {len(events) / wall:.2f} "
          f"events/s; launches {launches}", flush=True)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _launches_in(stderr: str):
    """Kernel launches summed over the --trace reports in stderr, and the
    number of reports."""
    from vapor_tpu_torch.engine import kernels
    total = dict.fromkeys(kernels.ALL_NAMES, 0)
    for name, n in re.findall(r"^kernel (\w+) launches=(\d+)$", stderr,
                              re.M):
        total[name] += int(n)
    return total, stderr.count("--- vapor-tpu-torch trace ---")


def _processes(cmds, label: str, timeout: float):
    """Runs the (command, environment) pairs at once from the repo root;
    returns their stderr texts.  Fails if any exits non-zero; kills every
    one that is still running when this returns."""
    procs = [_popen(cmd, cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
                    stderr=subprocess.PIPE, text=True)
             for cmd, env in cmds]
    try:
        errs = [p.communicate(timeout=timeout)[1] for p in procs]
    finally:
        for p in procs:
            _kill_group(p)
    for p, err in zip(procs, errs):
        _require(p.returncode == 0, f"{label}: a process exited "
                 f"{p.returncode}:\n{err[-3000:]}")
    return errs


def shards_phase(tmp, seed: int) -> None:
    """6b: the bed worklist dealt over 4 contigs, on the card, through
    scatter --jobs 2 (one process per contig), a 2-rank torch.distributed
    run (gloo, both ranks on cuda:0) and --shard-by-contig shards merged;
    each byte-equal to one plain run, each shard process's kernels
    counted by its --trace report."""
    from vapor_tpu_torch.engine import kernels
    from vapor_tpu_torch.orchestrate import merge_outputs
    from vapor_tpu_torch.sim.worklists import build_event_worklist
    d = os.path.join(tmp, "contigs")
    os.makedirs(d)
    fa, bam, bed, events = build_event_worklist(d, seed, n_contigs=4)
    with open(bed) as fh:
        contigs = sorted({x.split("\t")[0] for x in fh})
    _require(len(contigs) == 4, f"contigs {contigs}")
    plain_out = os.path.join(d, "plain.vapor")
    rows, wall, _ = _timed_run("4-contig bed", kernels.ALL_NAMES, "bed", fa,
                               bam, bed, plain_out)
    _require(len(rows) == len(events), f"{len(rows)} rows for "
             f"{len(events)} events")
    want = _read_bytes(plain_out)
    cli = [sys.executable, "-m", "vapor_tpu_torch"]
    files = ["--sv-input", bed, "--reference", fa, "--pacbio-input", bam,
             "--device", "cuda", "--no-figures", "--trace"]
    timings = [f"plain {wall:.2f} s, {len(events) / wall:.2f} events/s"]

    out = os.path.join(d, "scatter.vapor")
    t0 = time.perf_counter()
    errs = _processes([([*cli, "scatter", *files, "--scatter-mode", "bed",
                         "--jobs", "2", "--output-path",
                         os.path.join(d, "work"), "--output-file", out],
                        dict(os.environ))], "scatter", 900)
    t = time.perf_counter() - t0
    launches, reports = _launches_in(errs[0])
    _require(_read_bytes(out) == want, "scatter differs from the plain run")
    _require(reports == len(contigs), f"{reports} shard trace reports for "
             f"{len(contigs)} contigs")
    _require(all(launches.values()), f"scatter: a kernel never launched: "
             f"{launches}")
    timings.append(f"scatter --jobs 2 {t:.2f} s, {len(events) / t:.2f} "
                   f"events/s, launches {launches}")

    out = os.path.join(d, "dist.vapor")
    port = _free_port()
    base = {k: v for k, v in os.environ.items() if k not in (
        "RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    t0 = time.perf_counter()
    errs = _processes([([*cli, "bed", *files, "--output-path",
                         os.path.join(d, f"figs{rank}"), "--output-file",
                         out],
                        dict(base, RANK=str(rank), LOCAL_RANK=str(rank),
                             WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                             MASTER_PORT=str(port)))
                       for rank in range(2)], "2-rank run", 900)
    t = time.perf_counter() - t0
    launches, reports = _launches_in("".join(errs))
    _require(_read_bytes(out) == want, "the 2-rank run differs from the "
             "plain run")
    keys = []
    for rank in range(2):
        with open(f"{out}.shard{rank}") as fh:
            keys.append({tuple(x.split("\t")[:3]) for x in fh
                         if not x.startswith("#")})
    _require(keys[0] and keys[1] and not keys[0] & keys[1],
             f"rank shards of {len(keys[0])} and {len(keys[1])} rows, "
             f"{len(keys[0] & keys[1])} in both")
    _require(reports == 2 and all(launches.values()),
             f"2-rank run: {reports} trace reports, launches {launches}")
    timings.append(f"2 ranks (gloo, both on cuda:0) {t:.2f} s, "
                   f"{len(events) / t:.2f} events/s, shards of "
                   f"{len(keys[0])} and {len(keys[1])} events, launches "
                   f"{launches}")

    outs, t = [], 0.0
    for index in range(2):
        outs.append(os.path.join(d, f"by_contig{index}.vapor"))
        got, wall_i, _ = _timed_run(
            f"--shard-by-contig shard {index}", ("hist", "row_codes"), "bed",
            fa, bam, bed, outs[-1], extra=["--shard-by-contig",
                                           "--num-shards", "2",
                                           "--shard-index", str(index)])
        _require(got, f"--shard-by-contig shard {index} is empty")
        t += wall_i
    merged = os.path.join(d, "by_contig.vapor")
    merge_outputs(outs, merged)
    _require(_read_bytes(merged) == want, "--shard-by-contig shards merged "
             "differ from the plain run")
    timings.append(f"--shard-by-contig 2 shards in turn {t:.2f} s, "
                   f"{len(events) / t:.2f} events/s")
    print(f"phase 6b shards: {len(events)} events on {len(contigs)} "
          f"contigs, each output equal to the plain run: "
          + "; ".join(timings), flush=True)


def mesh_phase(fa, bam, events, reps: int) -> None:
    """6c: one fused_batch of the DUP 6000 rdd rows (hap_index, as the
    batching backend uploads them) and one of the DEL 9500 del rows,
    split by maybe_mesh_rows over two streams of cuda:0 and over every
    visible card: bit for bit the one-device launch, every kernel of the
    mode launched once per part."""
    import torch
    from vapor_tpu_torch.engine import kernels
    from vapor_tpu_torch.engine.fused import (batch_from_numpy, fused_batch,
                                              fused_batch_local)
    from vapor_tpu_torch.engine.kernels.timing import call_ms
    from vapor_tpu_torch.parallel.mesh import maybe_mesh_rows, mesh_devices
    dev = torch.device("cuda", 0)
    mode_kernels = {"rdd": ("hist", "kept_hist", "rdd_moment", "row_codes",
                            "kept_tables", "intercept_z"),
                    "del": ("hist", "left_hist", "moment2", "row_codes")}
    for svtype, body, mode in (("DUP", DUP_SIZES[-1], "rdd"),
                               ("DEL", SIZES[-1], "del")):
        ev = next(x for x in events if x[0] == svtype and
                  x[2] - x[1] == body)
        haps, fw, rlens, ms = _event_rows(fa, bam, ev, mode)
        idx = None
        if mode == "rdd":
            haps = haps[:1]
            idx = torch.zeros(fw.shape[0], dtype=torch.int64, device=dev)
        h, r, rl, m, k_idx = batch_from_numpy(haps, fw, rlens, ms, 0, dev)
        H, R = h.shape[1], r.shape[1]
        one = fused_batch_local(h, r, rl, m, k_idx, mode, idx)[2]
        kernels.reset_counts()
        split = maybe_mesh_rows(h, r, rl, m, k_idx, H, R, mode,
                                hap_index=idx, devices=[dev, dev])
        torch.cuda.synchronize()
        launched = {n: kernels.LAUNCHES[n] for n in mode_kernels[mode]}
        _require(split is not None and torch.equal(split, one),
                 f"{mode} rows split over two streams differ from one "
                 f"launch")
        _require(all(n == 2 for n in launched.values()),
                 f"{mode} split: launches {launched}, want 2 each")
        cards = mesh_devices(dev)
        every = fused_batch(h, r, rl, m, k_idx, H, R, mode,
                            hap_index=idx)[2]
        _require(torch.equal(every, one), f"{mode} rows over every visible "
                 f"card ({len(cards)}) differ from one launch")
        ms_one = call_ms(lambda: fused_batch_local(h, r, rl, m, k_idx,
                                                   mode, idx), reps)
        ms_two = call_ms(lambda: maybe_mesh_rows(
            h, r, rl, m, k_idx, H, R, mode, hap_index=idx,
            devices=[dev, dev]), reps)
        alone = " (one card: the one-device launch)" if len(cards) < 2 \
            else ""
        print(f"phase 6c rows across devices, {mode} B={r.shape[0]} H={H} "
              f"R={R}: two streams of cuda:0 equal one launch bit for bit, "
              f"launches {launched}; over the {len(cards)} visible card(s) "
              f"equal too{alone}; one launch {ms_one:.3f} ms, two streams "
              f"{ms_two:.3f} ms", flush=True)


# ---------------------------------------------------------------------------
# phase 7: accuracy and scale
# ---------------------------------------------------------------------------

def _vcf_rows_of(path: str, chrom: str) -> bytes:
    """The header lines of a VCF and its records on chrom, as bytes."""
    with open(path, "rb") as fh:
        return b"".join(x for x in fh if x.startswith(b"#") or
                        x.startswith(chrom.encode() + b"\t"))


def corpus_phase(tmp, launches) -> None:
    """7a: the ten-class truth corpus (sim/corpus.py build_corpus, 4
    contigs x 400 kb, het seed CORPUS_SEED, homo CORPUS_SEED + 1) through
    vcf --validate-vcf-tandup on the card: per-class results equal to
    ACCURACY_r5.json's (the JAX package's on the same corpus), and chr1's
    records also through the numpy oracle on the CPU, byte-equal."""
    from vapor_tpu_torch.engine import kernels
    from vapor_tpu_torch.sim.corpus import (build_corpus, evaluate,
                                            parse_annotated)
    with open(os.path.join(ROOT, "ACCURACY_r5.json")) as fh:
        reference = json.load(fh)["zygosity"]
    for i, zygosity in enumerate(("het", "homo")):
        d = os.path.join(tmp, f"corpus_{zygosity}")
        os.makedirs(d)
        t0 = time.perf_counter()
        fa, bam, vcf, truth = build_corpus(d, zygosity, CORPUS_CONTIGS,
                                           CORPUS_LEN, CORPUS_SEED + i)
        build_s = time.perf_counter() - t0
        run = shutil.copyfile(vcf, os.path.join(d, "cuda.vcf"))
        rows, wall, got = _timed_run(
            f"corpus {zygosity}", kernels.ALL_NAMES, "vcf", fa, bam, run,
            extra=["--validate-vcf-tandup"])
        _require(len(rows) == len(truth), f"corpus {zygosity}: "
                 f"{len(rows)} annotated records for {len(truth)} calls")
        per_class = evaluate(parse_annotated(run + ".vapor"), truth)
        want = reference[zygosity]["per_class"]
        differ = sorted(k for k in set(per_class) | set(want)
                        if per_class.get(k) != want.get(k))
        _require(not differ, f"corpus {zygosity}: per-class results differ "
                 f"from ACCURACY_r5.json in {differ}: " + "; ".join(
                     f"{k}: card {per_class.get(k)}, reference "
                     f"{want.get(k)}" for k in differ))
        recs = [r.split("VaPor_REC=")[1].split("\t")[0] for r in rows
                if "VaPor_REC=" in r]
        n_reads = sum(len(x.split(",")) for x in recs if x != "NA")
        for name in kernels.ALL_NAMES:
            launches[name] += got[name]
        one = os.path.join(d, "numpy_chr1.vcf")
        with open(one, "wb") as fo:
            fo.write(_vcf_rows_of(vcf, "chr1"))
        t1 = time.perf_counter()
        oracle_rows = run_cli("vcf", fa, bam, one, backend="numpy",
                              device="cpu", extra=["--validate-vcf-tandup"])
        oracle_s = time.perf_counter() - t1
        _require(oracle_rows and _read_bytes(one + ".vapor") ==
                 _vcf_rows_of(run + ".vapor", "chr1"),
                 f"corpus {zygosity}: chr1's annotated records differ "
                 f"between the card and the numpy oracle")
        print(f"phase 7a corpus {zygosity}: {len(truth)} calls (built in "
              f"{build_s:.1f} s), per-class results equal ACCURACY_r5.json"
              f"'s ({len(per_class)} classes); {n_reads} reads scored in "
              f"{wall:.2f} s: {len(truth) / wall:.2f} events/s, "
              f"{n_reads / wall:.1f} reads/s; launches {got}; chr1's "
              f"{len(oracle_rows)} records equal the numpy oracle's byte "
              f"for byte ({oracle_s:.1f} s on the CPU)", flush=True)


def band_phase(launches) -> None:
    """7b: the 108 tandem-array haps of sim/corpus.py repeat_cases through
    DeviceWindowRefiner on the card (self-stats rows through hist, the
    band QC on the host); each window equal to the exact host refiner's
    (engine/window.py window_size_refine, as _host_refine calls it),
    which runs afterwards in worker processes.  A hap's stall is its
    refine() call, call to return, where it hit the band."""
    import multiprocessing
    import torch
    from concurrent.futures import ProcessPoolExecutor
    from vapor_tpu_torch.engine import kernels, window_device
    from vapor_tpu_torch.engine.window import window_size_refine
    from vapor_tpu_torch.sim.corpus import repeat_cases
    haps = [case[3] for case in repeat_cases()]
    refiner = window_device.DeviceWindowRefiner(region_qc_cff=0.4, seed=0,
                                                device="cuda")
    kernels.reset_counts()
    band0 = dict(window_device.BAND_STATS)
    windows, stalls = [], []
    t0 = time.perf_counter()
    for hap in haps:
        hits0 = window_device.BAND_STATS["band_hits"]
        t1 = time.perf_counter()
        windows.append(refiner.refine(hap))
        if window_device.BAND_STATS["band_hits"] > hits0:
            stalls.append(time.perf_counter() - t1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    band = {x: window_device.BAND_STATS[x] - band0[x] for x in band0}
    selfstats = sum(n for (name, route, _, _), n
                    in kernels.LAUNCH_SHAPES.items()
                    if name == "hist" and route == "selfstats")
    _require(not any(kernels.PLAIN_CUDA_CALLS.values()),
             f"band leg: plain versions ran on CUDA tensors: "
             f"{kernels.PLAIN_CUDA_CALLS}")
    _require(band["band_hits"] > 0, f"band leg: no band hit: {band}")
    _require(selfstats == band["stat_rounds"] > 0,
             f"band leg: {band['stat_rounds']} refiner rounds in "
             f"{selfstats} self-stats launches of hist")
    for name in ("hist", "row_codes"):      # the refiner's rows
        launches[name] += kernels.LAUNCHES[name]
    t1 = time.perf_counter()
    n = len(haps)
    with ProcessPoolExecutor(
            max_workers=min(6, os.cpu_count() or 1),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        host = [w for w, _ in pool.map(window_size_refine, haps,
                                       [0.4] * n, [0] * n)]
    host_s = time.perf_counter() - t1
    bad = [i for i in range(n) if windows[i] != host[i]]
    _require(not bad, f"band leg: device windows differ from the host "
             f"refiner's on haps {bad}: "
             f"{[(windows[i], host[i]) for i in bad]}")
    print(f"phase 7b band leg: {n} repeat haps in {wall:.2f} s, "
          f"{band['band_hits']} band hits ({band['band_hits'] / n:.4f} a "
          f"hap) on {len(stalls)} haps, {selfstats} self-stats launches of "
          f"hist; stall where a hap hit: total {sum(stalls):.3f} s, mean "
          f"{sum(stalls) / len(stalls):.4f} s, max {max(stalls):.4f} s; "
          f"refiner {band}; every window equals the host refiner's "
          f"({host_s:.1f} s in worker processes)", flush=True)


def capstone_phase(tmp, launches, record) -> None:
    """7c: sim/scale.py build_scale_case at 4 contigs x 400 kb x 42
    events, 16 reads each (the capstone's widths at a sixth of its
    contigs): one pipelined bed run on the card, then the same run in a
    subprocess with --resume, killed (SIGKILL) once a third of its rows
    are written and rerun with --resume; the resumed output must equal
    the pipelined run's byte for byte.  The pipelined run's launch shapes
    and first calls go to `record`."""
    from vapor_tpu_torch.engine import kernels
    from vapor_tpu_torch.sim.scale import build_scale_case
    d = os.path.join(tmp, "capstone")
    os.makedirs(d)
    t0 = time.perf_counter()
    case = build_scale_case(d, n_contigs=CAPSTONE_CONTIGS,
                            contig_len=CORPUS_LEN, events_per=42,
                            reads_per=16)
    build_s = time.perf_counter() - t0
    n = case["n_events"]
    want = os.path.join(d, "pipelined.vapor")
    rows, wall, got = _timed_run("capstone", kernels.ALL_NAMES, "bed",
                                 case["fasta"], case["bam"], case["bed"],
                                 want, record=record)
    _require(len(rows) == n, f"capstone: {len(rows)} rows for {n} events")
    called = [r.split("\t") for r in rows if r.split("\t")[5] != "NA"]
    _require(called and all(math.isfinite(float(c[5])) for c in called),
             "capstone: no score, or a non-finite one")
    n_reads = sum(len(c[9].split(",")) for c in called)
    for name in kernels.ALL_NAMES:
        launches[name] += got[name]
    out = os.path.join(d, "resumed.vapor")
    cmd = [sys.executable, "-m", "vapor_tpu_torch", "bed", "--sv-input",
           case["bed"], "--reference", case["fasta"], "--pacbio-input",
           case["bam"], "--output-path", os.path.join(d, "figs_resume"),
           "--output-file", out, "--device", "cuda", "--no-figures",
           "--resume", "--trace"]

    def written() -> int:
        if not os.path.exists(out):
            return 0
        with open(out) as fh:
            return sum(1 for x in fh if not x.startswith("#"))

    t0 = time.perf_counter()
    proc = _popen(cmd, cwd=ROOT, stdout=subprocess.DEVNULL,
                  stderr=subprocess.DEVNULL)
    try:
        while proc.poll() is None and written() < n // 3:
            time.sleep(0.02)
            _require(time.perf_counter() - t0 < 600, "capstone: the run "
                     "to be killed wrote no third of its rows in 600 s")
    finally:
        _kill_group(proc)
    at_kill = written()
    _require(proc.returncode == -9 and 0 < at_kill < n,
             f"capstone: the run was not killed mid-run (exit "
             f"{proc.returncode}, {at_kill} of {n} rows)")
    t1 = time.perf_counter()
    err = _processes([(cmd, dict(os.environ))], "resumed capstone", 900)[0]
    resumed_s = time.perf_counter() - t1
    resumed, reports = _launches_in(err)
    _require(reports == 1 and resumed["hist"] > 0,
             f"capstone: the resumed run's launches {resumed}")
    _require(_read_bytes(out) == _read_bytes(want),
             "capstone: the resumed output differs from the pipelined run")
    print(f"phase 7c capstone: {n} events, {case['n_reads']} reads on "
          f"{CAPSTONE_CONTIGS} contigs (built in {build_s:.1f} s); "
          f"pipelined {wall:.2f} s: {n / wall:.2f} events/s, {n_reads} "
          f"reads scored, {n_reads / wall:.1f} reads/s; launches {got}; "
          f"killed at {at_kill} rows, resumed in {resumed_s:.2f} s "
          f"(process start included), launches {resumed}; resumed output "
          f"equal to the pipelined run byte for byte", flush=True)


# ---------------------------------------------------------------------------
# phase 8: the goldens and the pipeline depth
# ---------------------------------------------------------------------------

def goldens_phase(launches) -> None:
    """8a: every golden of fixtures/golden/ (sim/goldens.py: bed, the
    junction-mode bed, vcf of every SV type plain and annotated, the vcf
    fallbacks, svelter and ins) on the card through the default backend
    and through torch-nobatch; each output byte-equal to its golden,
    counts set to 0 before each golden and read after it.  The goldens
    launch GOLDEN_KERNELS: no golden scores a call by rdd (their DUP,
    DISDUP and DUP_INV calls are NA, and vcf mode validates no DUP
    record without --validate-vcf-tandup)."""
    from vapor_tpu_torch.engine import kernels
    from vapor_tpu_torch.sim import goldens
    for backend in ("torch", "torch-nobatch"):
        t0 = time.perf_counter()
        results = goldens.check_goldens(
            backend, "cuda", log=lambda line: print(line, flush=True))
        wall = time.perf_counter() - t0
        failed = sorted(n for n, r in results.items() if not r["ok"])
        _require(not failed, f"goldens [{backend}]: {failed} differ from "
                 f"fixtures/golden/")
        plain = {n: r["plain_on_cuda"] for n, r in results.items()
                 if r["plain_on_cuda"]}
        _require(not plain, f"goldens [{backend}]: plain versions ran on "
                 f"CUDA tensors: {plain}")
        total = {n: sum(r["launches"][n] for r in results.values())
                 for n in kernels.ALL_NAMES}
        _require(all(total[n] for n in GOLDEN_KERNELS), f"goldens "
                 f"[{backend}]: a kernel of the path never launched: "
                 f"{total}")
        for name in kernels.ALL_NAMES:
            launches[name] += total[name]
        print(f"phase 8a goldens [{backend}]: {len(results)} of "
              f"{len(results)} byte-equal to fixtures/golden/ in {wall:.2f} "
              f"s; launches {total}", flush=True)


def pdf_phase(tmp, fa, bam, events, launches) -> None:
    """8a, pdf mode, which has no golden: phase 4's smallest tandem DUPs
    and DEL as a 4-column BED, --sv-type TANDUP --size-cff 50, on the
    card through the default backend against the numpy oracle on the
    CPU, byte for byte; the DEL is filtered out, the DUPs score by
    rdd."""
    from vapor_tpu_torch.engine import kernels
    d = os.path.join(tmp, "pdf")
    os.makedirs(d)
    bed4 = os.path.join(d, "calls.bed")
    keep = [(t, s, e) for t, s, e in events if e - s == DUP_SIZES[0] and
            t in ("DUP", "DEL")]
    with open(bed4, "w") as fo:
        fo.writelines(f"chrE\t{s}\t{e}\t{t}\n" for t, s, e in keep)
    flags = ["--sv-type", "TANDUP", "--size-cff", "50", "--PB-supp", "3"]
    rows, wall, got = _timed_run(
        "pdf", RDD_KERNELS, "pdf", fa, bam, bed4,
        os.path.join(d, "cuda.vapor"), extra=flags)
    want = run_cli("pdf", fa, bam, bed4, os.path.join(d, "numpy.vapor"),
                   backend="numpy", device="cpu", extra=flags)
    n_dup = sum(t == "DUP" for t, _, _ in keep)
    _require(rows == want and len(rows) == n_dup and
             all(r.split("\t")[1] != "NA" for r in rows),
             f"pdf on the card: {rows} against the numpy oracle's {want}")
    for name in kernels.ALL_NAMES:
        launches[name] += got[name]
    print(f"phase 8a pdf: {n_dup} of {len(keep)} calls kept by --sv-type, "
          f"scored, equal to the numpy oracle in {wall:.2f} s; launches "
          f"{got}", flush=True)


def depth_phase(tmp, fa, bam, bed, want: str, launches) -> None:
    """8b: phase 4's bed worklist at --pipeline 1 (no two events share a
    launch) and at 24, each byte-equal to phase 4's output."""
    from vapor_tpu_torch.engine import kernels
    for depth in (1, 24):
        out = os.path.join(tmp, f"depth{depth}.vapor")
        rows, wall, got = _timed_run(
            f"bed --pipeline {depth}", kernels.ALL_NAMES, "bed", fa, bam, bed,
            out, extra=["--pipeline", str(depth)])
        _require(_read_bytes(out) == _read_bytes(want),
                 f"bed --pipeline {depth} differs from phase 4")
        for name in kernels.ALL_NAMES:
            launches[name] += got[name]
        print(f"phase 8b pipeline depth {depth}: {len(rows)} events equal "
              f"to phase 4 in {wall:.2f} s: {len(rows) / wall:.2f} "
              f"events/s; launches {got}", flush=True)


# ---------------------------------------------------------------------------
# phase 9: the v1 dense engine (--backend torch-v1)
# ---------------------------------------------------------------------------

def _v1_rows(fa, bam, event, mode: str):
    """Phase 3's rows of one event as the v1 engine takes them: the (H,)
    hap, the (B, R) forward and reverse-complement read codes, rlens and
    ms."""
    import numpy as np
    from vapor_tpu_torch.engine import oracle
    from vapor_tpu_torch.engine.constants import READ_PAD
    haps, fw, rlens, ms = _event_rows(fa, bam, event, mode)
    rc = np.full_like(fw, READ_PAD)
    for b, n in enumerate(rlens):
        rc[b, :n] = oracle._COMP_LUT[fw[b, :n]][::-1]
    return np.array(haps[0]), fw, rc, rlens, ms


def _v1_on(dev, rows, k: int, H: int, R: int, tables, oms, zs, mode: str,
           use_masks: bool, hits=None):
    """One _dot_stats_batch pass of the v1 engine on `dev`; the decoded
    HapStats."""
    import numpy as np
    import torch
    from vapor_tpu_torch.engine import kernel as v1

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    out = v1._dot_stats_batch(*map(put, (*rows, *tables, oms, zs)), k,
                              H=H, R=R, mode=mode, use_masks=use_masks,
                              hits=None if hits is None else
                              tuple([h] for h in hits))
    return v1.HapStats(*(x.cpu().numpy() for x in out))


def _v1_equal(a, b) -> bool:
    from vapor_tpu_torch.engine import kernel as v1
    return all(getattr(a, x).shape == getattr(b, x).shape and
               (getattr(a, x) == getattr(b, x)).all()
               for x in v1.STATS + ("h_d", "h_a"))


def _v1_hits(dev, rows, k: int, H: int, R: int):
    """The (bb, ii, cc) hit coordinates of each strand, its blocks
    joined."""
    import torch
    from vapor_tpu_torch.engine import kernel as v1
    hap, fw, rc, _, ms = (torch.from_numpy(x).to(dev) for x in rows)
    return tuple(tuple(map(torch.cat, zip(*v1._hit_blocks(
        hap, x, ms.long(), k, H, R)))) for x in (fw, rc))


def v1_engine_phase(fa, bam, events, seed: int, reps: int) -> None:
    """9a: the v1 engine's _dot_stats_batch on the card against the same
    function on the CPU, on phase 3's rows of the smallest DEL (del
    rows), INV (m1b) and DUP (rdd), k = 10 and 40: the hit coordinates
    of both strands, then every mode (hist unmasked and masked, m1b,
    w10, rdd, all) with the m1b cleaning tables as masks, or_mode 0 and
    1 on alternate rows and a nonzero z; every decoded integer equal.
    Then, at the main path's largest shape (the largest DUP's rdd rows,
    H = R = 16384): one read held against the CPU in mode all, and the
    card's ms per read of the first pass (hits and histograms) and of a
    later masked pass, and its peak memory."""
    import numpy as np
    import torch
    from vapor_tpu_torch.engine import kernel as v1
    from vapor_tpu_torch.engine.kernels.timing import call_ms
    rng = np.random.default_rng(seed)
    cuda = torch.device("cuda")
    cases = [("DEL", SIZES[0], "del"), ("INV", SIZES[0], "m1b"),
             ("DUP", DUP_SIZES[0], "rdd")]
    n_checked = 0
    for svtype, body, mode in cases:
        ev = next(e for e in events if e[0] == svtype and
                  e[2] - e[1] == body)
        rows = _v1_rows(fa, bam, ev, mode)
        B, R = rows[1].shape
        H = rows[0].shape[0]
        WH = v1._hist_layout(H, R)[0]
        oms = (np.arange(B) % 2).astype(np.int32)
        zs = rng.integers(-60, 61, B).astype(np.int32)
        ones = np.ones((B, WH), dtype=bool)
        for k in (10, 40):
            hits = {d: _v1_hits(d, rows, k, H, R) for d in (cuda, "cpu")}
            _require(all(torch.equal(g.cpu(), w) for g, w in zip(
                sum(hits[cuda], ()), sum(hits["cpu"], ()))),
                f"v1 hit coordinates differ from the CPU's: {svtype} "
                f"{body}, k={k}")
            p = _v1_on(cuda, rows, k, H, R, (ones, ones), oms, zs, "hist",
                       False, hits[cuda])
            _require(_v1_equal(p, _v1_on("cpu", rows, k, H, R, (ones, ones),
                                         oms, zs, "hist", False,
                                         hits["cpu"])),
                     f"v1 hist pass differs from the CPU's: {svtype} "
                     f"{body}, k={k}")
            tables = tuple(np.stack([v1.kept_table(h, 10, 10, False)
                                     for h in x]) for x in (p.h_d, p.h_a))
            for m, masked in (("hist", True), ("m1b", True), ("w10", True),
                              ("rdd", True), ("all", True),
                              ("all", False)):
                got, want = (_v1_on(d, rows, k, H, R, tables, oms, zs, m,
                                    masked, hits[d]) for d in (cuda, "cpu"))
                _require(_v1_equal(got, want), f"v1 mode {m} (masks "
                         f"{masked}) differs from the CPU's: {svtype} "
                         f"{body}, k={k}")
                n_checked += 1
            print(f"phase 9a v1 {svtype} {body} ({mode} rows) B={B} H={H} "
                  f"R={R} k={k}: {int(p.n_dots.sum())} hits; hit "
                  f"coordinates and 7 passes equal to the CPU's", flush=True)

    ev = next(e for e in events if e[0] == "DUP" and
              e[2] - e[1] == DUP_SIZES[-1])
    rows = _v1_rows(fa, bam, ev, "rdd")
    B, R = rows[1].shape
    H = rows[0].shape[0]
    WH = v1._hist_layout(H, R)[0]
    oms = (np.arange(B) % 2).astype(np.int32)
    zs = rng.integers(-60, 61, B).astype(np.int32)
    ones = np.ones((B, WH), dtype=bool)
    k = 10
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    p = _v1_on(cuda, rows, k, H, R, (ones, ones), oms, zs, "hist", False)
    first_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    tables = tuple(np.stack([v1.kept_table(h, 10, 10, False) for h in x])
                   for x in (p.h_d, p.h_a))
    hits = _v1_hits(cuda, rows, k, H, R)
    hits_ms = call_ms(lambda: _v1_hits(cuda, rows, k, H, R), 1)
    pass_ms = call_ms(lambda: _v1_on(cuda, rows, k, H, R, tables, oms, zs,
                                     "rdd", True, hits), reps)
    one = (rows[0], *(x[:1] for x in rows[1:]))
    got, want = (_v1_on(d, one, k, H, R, tuple(t[:1] for t in tables),
                        oms[:1], zs[:1], "all", True) for d in (cuda, "cpu"))
    _require(_v1_equal(got, want), f"v1 at H={H} R={R} differs from the "
             f"CPU's on one read")
    print(f"phase 9a v1 at the largest shape, DUP {DUP_SIZES[-1]} (rdd "
          f"rows) B={B} H={H} R={R} k={k}: {int(p.n_dots.sum())} hits; one "
          f"read in mode all equal to the CPU's; first pass {first_ms:.1f} "
          f"ms ({first_ms / B:.2f} ms a read), hit coordinates {hits_ms:.1f} "
          f"ms ({hits_ms / B:.2f} ms a read), a masked rdd pass on them "
          f"{pass_ms:.2f} ms ({pass_ms / B:.3f} ms a read); peak memory "
          f"{peak / 2 ** 30:.3f} GiB (random sequence); {n_checked} passes "
          f"held equal at the smaller shapes", flush=True)
    v1_repeat_memory(cuda)


def v1_repeat_memory(dev) -> None:
    """9a on dense hits: a 2-bp tandem-repeat hap of 16,000 bases against
    two reads of the same repeat (H = R = 16384), where every in-phase
    cell is a hit: one unmasked pass in mode all on the card, its hit
    count the repeat's exact count, every hit once in each histogram,
    and its peak memory, which the streamed blocks bound whatever the
    number of hits."""
    import numpy as np
    import torch
    from vapor_tpu_torch.engine import kernel as v1
    from vapor_tpu_torch.engine import oracle
    L, B, k = 16000, 2, 10
    H = R = v1.bucket_for(L + 1)
    rep = oracle.encode("AC" * (L // 2))
    hap = np.full(H, v1.HAP_PAD, dtype=np.uint8)
    hap[:L] = rep
    fw = np.full((B, R), v1.READ_PAD, dtype=np.uint8)
    fw[:, :L] = rep
    rc = np.full_like(fw, v1.READ_PAD)
    rc[:, :L] = oracle._COMP_LUT[rep][::-1]
    zeros = np.zeros(B, dtype=np.int32)
    ones = np.ones((B, v1._hist_layout(H, R)[0]), dtype=bool)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    p = _v1_on(dev, (hap, fw, rc, np.full(B, L, dtype=np.int32), zeros),
               k, H, R, (ones, ones), zeros, zeros, "all", False)
    wall_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    n = L - k + 1                  # k-mer starts in the hap and in a read
    want = ((n + 1) // 2) ** 2 + (n // 2) ** 2    # pairs of one parity
    _require(all((x == want).all() for x in (p.n_dots, p.cnt,
                                             p.h_d.sum(1), p.h_a.sum(1))),
             f"v1 tandem repeat: {p.n_dots} hits, {p.cnt} kept, histogram "
             f"totals {p.h_d.sum(1)} / {p.h_a.sum(1)}; the repeat gives "
             f"{want} a read")
    print(f"phase 9a v1 on a 2-bp tandem repeat B={B} H={H} R={R} k={k}: "
          f"{want} hits a read, as the repeat gives, each once in both "
          f"histograms; one pass in mode all {wall_ms:.1f} ms "
          f"({wall_ms / B:.1f} ms a read); peak memory "
          f"{peak / 2 ** 30:.3f} GiB", flush=True)


def v1_goldens_phase(launches) -> None:
    """9b: every golden of fixtures/golden/ through --backend torch-v1 on
    the card (sim/goldens.py, counts set to 0 before each golden), each
    byte-equal to its golden.  The v1 engine's own device work is torch
    ops; the path's one kernel is hist, through the device window
    refiner's self-stats rows."""
    from vapor_tpu_torch.engine import kernels
    from vapor_tpu_torch.sim import goldens
    t0 = time.perf_counter()
    results = goldens.check_goldens(
        "torch-v1", "cuda", log=lambda line: print(line, flush=True))
    wall = time.perf_counter() - t0
    failed = sorted(n for n, r in results.items() if not r["ok"])
    _require(not failed, f"goldens [torch-v1]: {failed} differ from "
             f"fixtures/golden/")
    plain = {n: r["plain_on_cuda"] for n, r in results.items()
             if r["plain_on_cuda"]}
    _require(not plain, f"goldens [torch-v1]: plain versions ran on CUDA "
             f"tensors: {plain}")
    total = {n: sum(r["launches"][n] for r in results.values())
             for n in kernels.ALL_NAMES}
    _require(total["hist"] > 0 and total["row_codes"] > 0 and not any(
        total[n] for n in kernels.ALL_NAMES if n not in V1_KERNELS),
        f"goldens [torch-v1]: the refiner's hist or row_codes did not "
        f"launch, or a fused engine kernel did: {total}")
    for name in V1_KERNELS:
        launches[name] += total[name]
    print(f"phase 9b goldens [torch-v1]: {len(results)} of {len(results)} "
          f"byte-equal to fixtures/golden/ in {wall:.2f} s; launches "
          f"{total}", flush=True)


def v1_bed_phase(tmp, fa, bam, bed, events, want: str, wall_torch: float,
                 launches) -> None:
    """9c: phase 4's bed worklist through --backend torch-v1 on the card,
    byte-equal to phase 4's output; events/s beside phase 4's (the
    default backend), and the hist launches of the refiner."""
    from vapor_tpu_torch.engine import kernels
    out = os.path.join(tmp, "v1.vapor")
    rows, wall, got = _timed_run("bed torch-v1", V1_KERNELS, "bed", fa, bam,
                                 bed, out, backend="torch-v1")
    _require(_read_bytes(out) == _read_bytes(want),
             "bed --backend torch-v1 differs from phase 4")
    _require(not any(got[n] for n in kernels.ALL_NAMES
                     if n not in V1_KERNELS),
             f"bed torch-v1 launched a fused engine kernel: {got}")
    for name in V1_KERNELS:
        launches[name] += got[name]
    print(f"phase 9c bed [torch-v1]: all {len(rows)} events equal to phase "
          f"4 in {wall:.2f} s: {len(rows) / wall:.2f} events/s (the "
          f"default backend {len(events) / wall_torch:.2f}); hist launches "
          f"of the refiner {got['hist']}", flush=True)


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
        from vapor_tpu_torch.sim.worklists import (build_event_worklist,
                                                   build_vcf_worklist)
    except ImportError as exc:
        print(f"chip_smoke: vapor_tpu_torch not importable: {exc}",
              file=sys.stderr)
        return 1
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"card {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    logs = build.build(extra_flags=["-Xptxas=-v"])
    print(f"phase 1 build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        print_ptxas(name, log)
    tile_smem()

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        fa, bam, bed, events = build_event_worklist(tmp, args.seed)
        vdir = os.path.join(tmp, "vcf")
        os.makedirs(vdir)
        vfa, vbam, vcf, vevents = build_vcf_worklist(vdir, args.seed)
        print(f"phase 2 input: {len(events)} bed events, {len(vevents)} "
              f"vcf events in {time.perf_counter() - t0:.1f} s",
              flush=True)

        report = kernel_parity(fa, bam, events, args.reps)
        repeat_parity(args.seed, args.reps, report)
        walk_waves(report)
        selfstats_parity(fa, events, args.reps, report)
        glue_crafted(args.seed, args.reps, report)
        print("phase 3 kernel parity: all equal", flush=True)

        # bed: DEL (del, w10 junction), INV (m1b, w10 junction) and DUP
        # (rdd) run all six kernels; the default backend first, then
        # torch-nobatch (one launch per request), which must agree
        runs = {"bed": MainPath(), "capstone": MainPath()}
        rows, wall, launches = _timed_run(
            "bed", kernels.ALL_NAMES, "bed", fa, bam, bed,
            os.path.join(tmp, "cuda.vapor"), record=runs["bed"])
        _require(len(rows) == len(events),
                 f"{len(rows)} rows for {len(events)} events")
        called = [r.split("\t") for r in rows if r.split("\t")[5] != "NA"]
        _require(all(math.isfinite(float(c[5])) for c in called),
                 "non-finite quality score")
        _require(all(r.split("\t")[5] != "NA" for r in rows
                     if r.split("\t")[3] == "TANDUP"),
                 "a tandem DUP was not scored")
        n_reads = sum(len(c[9].split(",")) for c in called)
        rows_nb, wall_nb, launches_nb = _timed_run(
            "bed torch-nobatch", kernels.ALL_NAMES, "bed", fa, bam, bed,
            os.path.join(tmp, "nobatch.vapor"), backend="torch-nobatch")
        _require(rows_nb == rows, "bed: torch-nobatch differs from the "
                 "default backend")
        # unbatched, each whole-event DUP launches both rdd kernels for
        # its ref and alt haps at least (batching merges them)
        whole_dups = sum(1 for t, s, e in events if t == "DUP")
        _require(all(launches_nb[n] >= 2 * whole_dups
                     for n in ("kept_hist", "rdd_moment")),
                 f"fewer than 2 rdd launches per whole-event DUP "
                 f"({whole_dups}): {launches_nb}")
        print(f"phase 4 end to end, bed: {len(rows)} events, {len(called)} "
              f"called, {n_reads} reads scored in {wall:.2f} s: "
              f"{len(rows) / wall:.2f} events/s, {n_reads / wall:.1f} "
              f"reads/s; launches {launches}; torch-nobatch equal, "
              f"{wall_nb:.2f} s: {len(rows) / wall_nb:.2f} events/s; "
              f"launches {launches_nb}", flush=True)

        # vcf: DISDUP, DUP_INV and the complex event all score by rdd
        # vcf mode rewrites <sv-input>.vapor: run on copies of the input
        vrun = shutil.copyfile(vcf, os.path.join(vdir, "cuda.vcf"))
        vrows, vwall, vlaunches = _timed_run(
            "vcf", RDD_KERNELS, "vcf", vfa, vbam,
            vrun)
        _require(len(vrows) == len(vevents),
                 f"{len(vrows)} annotated records for {len(vevents)} "
                 f"events")
        recs = [r.split("VaPor_REC=")[1].split("\t")[0] for r in vrows]
        _require(all(x != "NA" for x in recs), "a vcf event was not scored")
        gs = [float(r.split("VaPor_GS=")[1].split(";")[0]) for r in vrows]
        _require(all(math.isfinite(x) for x in gs), "non-finite GS")
        v_reads = sum(len(x.split(",")) for x in recs)
        vrows_nb, vwall_nb, vlaunches_nb = _timed_run(
            "vcf torch-nobatch", RDD_KERNELS, "vcf",
            vfa, vbam, shutil.copyfile(vcf, os.path.join(vdir,
                                                          "nobatch.vcf")),
            backend="torch-nobatch")
        _require(vrows_nb == vrows, "vcf: torch-nobatch differs from the "
                 "default backend")
        print(f"phase 4 end to end, vcf: {len(vrows)} events, {v_reads} "
              f"reads scored in {vwall:.2f} s: {len(vrows) / vwall:.2f} "
              f"events/s, {v_reads / vwall:.1f} reads/s; launches "
              f"{vlaunches}; torch-nobatch equal, {vwall_nb:.2f} s: "
              f"{len(vrows) / vwall_nb:.2f} events/s; launches "
              f"{vlaunches_nb}", flush=True)
        for name in kernels.ALL_NAMES:
            launches[name] += vlaunches[name]

        # the 4 smallest DEL/INV events and the 2 smallest DUPs; the
        # vcf's smallest DISDUP, DUP_INV and complex event
        keep_bed = [i for i, (t, s, e) in enumerate(events)
                    if e - s == min(SIZES[0], DUP_SIZES[0])]
        small = _copy_lines(bed, os.path.join(tmp, "small.bed"),
                            lambda i: i in keep_bed)
        with open(vcf) as fh:
            n_meta = sum(1 for x in fh if x.startswith("#"))
        with open(vrun + ".vapor") as fh:
            vcard = fh.read().splitlines()
        for backend, device in (("torch", "cpu"), ("numpy", "cpu")):
            ref = run_cli("bed", fa, bam, small,
                          os.path.join(tmp, f"{backend}.vapor"),
                          backend=backend, device=device)
            _require(ref == [rows[i] for i in keep_bed],
                     f"bed: {backend} on {device} differs from the card "
                     f"on the smallest events")
            vsmall = _copy_lines(vcf, os.path.join(vdir, f"{backend}.vcf"),
                                 lambda i: i < n_meta + 3)
            run_cli("vcf", vfa, vbam, vsmall, backend=backend,
                    device=device)
            with open(vsmall + ".vapor") as fh:
                got = fh.read().splitlines()
            _require(got == vcard[:len(got)] and
                     sum(not x.startswith("#") for x in got) == 3,
                     f"vcf: {backend} on {device} differs from the card "
                     f"on the 3 smallest events")
        print(f"phase 5 cross-check: the card's rows for the {len(keep_bed)}"
              f" smallest bed events and its annotated VCF for the 3 "
              f"smallest vcf events equal the CPU and numpy-oracle runs "
              f"byte for byte", flush=True)

        t0 = time.perf_counter()
        codec_phase(tmp, fa, bam, bed, events, rows, wall)
        shards_phase(tmp, args.seed)
        mesh_phase(fa, bam, events, args.reps)
        print(f"phase 6 scale-out: {time.perf_counter() - t0:.1f} s",
              flush=True)

        t0 = time.perf_counter()
        corpus_phase(tmp, launches)
        band_phase(launches)
        capstone_phase(tmp, launches, runs["capstone"])
        print(f"phase 7 accuracy and scale: {time.perf_counter() - t0:.1f} "
              f"s", flush=True)

        t0 = time.perf_counter()
        goldens_phase(launches)
        pdf_phase(tmp, fa, bam, events, launches)
        depth_phase(tmp, fa, bam, bed, os.path.join(tmp, "cuda.vapor"),
                    launches)
        print(f"phase 8 goldens and pipeline depth: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

        t0 = time.perf_counter()
        v1_engine_phase(fa, bam, events, args.seed, args.reps)
        v1_goldens_phase(launches)
        v1_bed_phase(tmp, fa, bam, bed, events,
                     os.path.join(tmp, "cuda.vapor"), wall, launches)
        print(f"phase 9 v1 engine: {time.perf_counter() - t0:.1f} s",
              flush=True)

        t0 = time.perf_counter()
        bucket_parity(runs, args.reps, report)
        glue_bucket_parity(runs, args.reps, report)
        floor_split(runs, report)
        print(f"phase 3 buckets: {time.perf_counter() - t0:.1f} s",
              flush=True)

    glue_keys = ("device_ms", "call_ms", "host_us", "bound_share",
                 "lost_ms_bed", "lost_ms_capstone", "bound_share_bed",
                 "bound_share_capstone", "device_ms_bed",
                 "device_ms_capstone", "plain_device_ms", "plain_host_us",
                 "plain_device_ms_bed", "plain_device_ms_capstone",
                 "buckets")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"vapor_tpu_torch/engine/kernels/csrc/"
                   f"{build.source(name)}",
         "replaces": REPLACES[name],
         "launches": launches[name],
         "max_abs_err": report[name]["max_abs_err"],
         "ms": report[name]["ms"], "plain_ms": report[name]["plain_ms"],
         "bound_ms": report[name]["bound_ms"],
         "bound_by": report[name]["bound_by"],
         "library_ms": None, "shape": report[name]["shape"],
         **{x: report[name][x] for x in (
             "device_ms", "call_ms", "host_us", "bound_share",
             "l2", "lost_ms_bed", "lost_ms_capstone", "bound_share_bed",
             "bound_share_capstone", "small_ms", "small_shape", "buckets")},
         **{x: report[name][x] for x in (
             "repeat_ms", "repeat_bound_ms", "waves", "selfstats_ms",
             "selfstats_plain_ms", "selfstats_bound_ms", "selfstats_shape",
             "selfstats", "floor")
            if x in report[name]}}
        for name in kernels.NAMES] + [
        {"name": name, "route": "cuda",
         "source": f"vapor_tpu_torch/engine/kernels/csrc/"
                   f"{build.source(name)}",
         "replaces": REPLACES[name], "launches": launches[name],
         **{x: report[name][x] for x in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": None, "shape": report[name]["shape"],
         **{x: report[name][x] for x in glue_keys}}
        for name in kernels.GLUE_NAMES]}))
    from vapor_tpu_torch.engine.kernels.roofline import card_line
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        _stop_all()
    sys.exit(code)
