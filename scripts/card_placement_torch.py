#!/usr/bin/env python3
"""Where the work of a multi-process run lands on a host with several
cards: the 4-contig bed worklist of chip_smoke.py phase 6b (seed 7, 34
events) through one plain process, scatter --jobs 4 (one shard per
contig) and 4 ranks under torchrun's environment (gloo), each process
reporting at exit the cards it allocated device memory on; every
output byte-equal to the plain run's.

    python3 scripts/card_placement_torch.py [--tree DIR] [--reps N]
        [--device cuda|cpu] [--out PATH]

--tree runs another checkout of the port (for a comparison of two
commits in one call).  A process's cards come from a sitecustomize hook
that this script writes into a temporary directory on the processes'
PYTHONPATH (torch.cuda.max_memory_allocated of each card at exit), so
the tree needs no instrumentation of its own.  On the card the run needs
nvcc; it exits 1 without a card unless --device cpu (the tests' small
case: 4 contigs x 30 kb).  Writes JSON under chiprun_out/.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import time

DIST_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
            "MASTER_ADDR", "MASTER_PORT")
PROBE = '''import atexit, os, sys


def _report():
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return
    used = [i for i in range(torch.cuda.device_count())
            if torch.cuda.max_memory_allocated(i) > 0]
    sys.stderr.write(f"placement local_rank={os.environ.get('LOCAL_RANK')}"
                     f" cards={used}\\n")


atexit.register(_report)
'''


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _run(cmds, tree: str) -> dict:
    """Runs the (command, environment) pairs at once; their wall seconds
    and each reporting process's (LOCAL_RANK, cards)."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, env=env, cwd=tree,
                              stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE, text=True)
             for cmd, env in cmds]
    try:
        errs = [p.communicate(timeout=900)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    wall = time.perf_counter() - t0
    for p, err in zip(procs, errs):
        if p.returncode:
            raise RuntimeError(f"a process exited {p.returncode}:\n"
                               f"{err[-3000:]}")
    found = re.findall(r"^placement local_rank=(\S+) cards=(\[[^\]]*\])$",
                       "".join(errs), re.M)
    return {"wall_s": wall,
            "processes": [{"local_rank": r, "cards": json.loads(c)}
                          for r, c in found]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=".")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=os.path.join(
        "chiprun_out", "card_placement.json"))
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("card_placement: no CUDA card", file=sys.stderr)
        return 1
    report = {"tree": args.tree, "device": args.device}
    if args.device == "cuda":
        from vapor_tpu_torch.engine.kernels import build
        from vapor_tpu_torch.engine.kernels.roofline import card_line
        build.build()
        report.update(cards=torch.cuda.device_count(), card=card_line())
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "sitecustomize.py"), "w") as fh:
            fh.write(PROBE)
        base = {k: v for k, v in os.environ.items() if k not in DIST_ENV}
        base["PYTHONPATH"] = os.pathsep.join([d, tree])
        if args.device == "cuda":
            from vapor_tpu_torch.sim.worklists import build_event_worklist
            fa, bam, bed, _ = build_event_worklist(d, 7, n_contigs=4)
        else:
            from vapor_tpu_torch.sim.scale import build_scale_case
            case = build_scale_case(d, n_contigs=4, contig_len=30000,
                                    events_per=2, reads_per=6,
                                    n_false_per=0, seed=9)
            fa, bam, bed = case["fasta"], case["bam"], case["bed"]
        cli = [sys.executable, "-m", "vapor_tpu_torch"]
        files = ["--sv-input", bed, "--reference", fa, "--pacbio-input",
                 bam, "--device", args.device, "--no-figures"]

        def bed_run(out, figs):
            return [*cli, "bed", *files, "--output-path", figs,
                    "--output-file", out]
        plain = os.path.join(d, "plain.vapor")
        report["plain"] = _run([(bed_run(plain, os.path.join(d, "f")),
                                 base)], tree)
        with open(plain, "rb") as fh:
            want = fh.read()
        for rep in range(args.reps):
            out = os.path.join(d, f"scatter{rep}.vapor")
            got = _run([([*cli, "scatter", *files, "--scatter-mode", "bed",
                          "--jobs", "4", "--output-path",
                          os.path.join(d, f"work{rep}"), "--output-file",
                          out], base)], tree)
            with open(out, "rb") as fh:
                got["equal"] = fh.read() == want
            report[f"scatter{rep}"] = got
            out, port = os.path.join(d, f"ranks{rep}.vapor"), _free_port()
            got = _run([(bed_run(out, os.path.join(d, f"g{rep}_{r}")),
                         dict(base, RANK=str(r), LOCAL_RANK=str(r),
                              WORLD_SIZE="4", MASTER_ADDR="127.0.0.1",
                              MASTER_PORT=str(port))) for r in range(4)],
                       tree)
            with open(out, "rb") as fh:
                got["equal"] = fh.read() == want
            report[f"ranks{rep}"] = got
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(report, fh, indent=1)
    print(json.dumps(report))
    ok = all(v["equal"] for k, v in report.items()
             if k.startswith(("scatter", "ranks")))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
