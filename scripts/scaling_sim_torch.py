#!/usr/bin/env python3
"""Two-rank scaling of vapor_tpu_torch: the bed CLI on a multi-contig
worklist in 1 process against 2 torch.distributed ranks.

The ranks get torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR=127.0.0.1 and a free MASTER_PORT): the CLI joins a gloo
group, each rank scores its contig-granular shard on
cuda:{LOCAL_RANK % cards} (both on cuda:0 on a one-card machine), and
rank 0 writes the merged rows (vapor_tpu_torch/parallel/multihost.py).
Each process records its own wall time from the CLI's entry to the
merged output (process and library start-up excluded: a per-host
constant that a genome-scale worklist amortizes); the 2-rank time is the
slower rank's, and the efficiency is t_1 / (2 t_2).  The merged rows
must equal the 1-process rows.  Each process runs one compute thread
(OMP_NUM_THREADS=1 and the like), as identical hosts would.  An
untimed process first builds the kernels and the BAM codec.

The worklist is vapor_tpu_torch/sim/scale.py build_scale_case (seed 31,
one false call per contig).

    python3 scripts/scaling_sim_torch.py [--contigs 8] [--events-per 45]
        [--reads-per 12] [--contig-len 400000] [--device cuda|cpu]
        [--out chiprun_out/scaling_sim_torch.json]
"""
import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

DIST_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
             "MASTER_PORT")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def one_thread_env(**extra):
    """The caller's environment with one compute thread per process and
    no torchrun variables, plus `extra`."""
    env = {k: v for k, v in os.environ.items() if k not in DIST_VARS}
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                "MKL_NUM_THREADS"):
        env[var] = "1"
    env.update(extra)
    return env


def cli_cmd(case, figdir, out, tfile, device, extra=(), pfile=None):
    """A bed CLI process that appends its own wall time, from the CLI's
    entry to its return, to tfile; with pfile, the call runs under
    cProfile and the top 30 entries by cumulative time go to pfile."""
    args = ["bed", "--sv-input", case["bed"], "--reference", case["fasta"],
            "--pacbio-input", case["bam"], "--output-path", figdir,
            "--output-file", out, "--backend", "torch", "--device", device,
            "--no-figures", *extra]
    run = "rc = main({args!r})"
    if pfile:
        run = ("import cProfile, io, pstats; prof = cProfile.Profile();"
               "rc = prof.runcall(main, {args!r})")
    code = ("import sys, time; sys.path.insert(0, {repo!r});"
            "from vapor_tpu_torch.cli import main;"
            "t0 = time.perf_counter();" + run + ";"
            "open({tfile!r}, 'a').write(f'{{time.perf_counter() - t0}}\\n');")
    if pfile:
        code += ("out = io.StringIO();"
                 "pstats.Stats(prof, stream=out).sort_stats('cumulative')"
                 ".print_stats(30);"
                 "open({pfile!r}, 'w').write(out.getvalue());")
    code += "raise SystemExit(rc)"
    return [sys.executable, "-c", code.format(repo=REPO, tfile=tfile,
                                               args=args, pfile=pfile)]


def run_all(cmds, timeout=1800):
    """Starts the (command, environment) pairs at once; fails if any
    exits non-zero, and kills every one still running on the way out."""
    procs = [subprocess.Popen(cmd, env=env, cwd=REPO,
                              stdout=subprocess.DEVNULL) for cmd, env in cmds]
    try:
        rcs = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    if any(rcs):
        raise RuntimeError(f"processes exited {rcs}")


def times(tfile):
    with open(tfile) as fh:
        return [float(x) for x in fh.read().split()]


def rows(path):
    with open(path) as fh:
        return sorted(line for line in fh if not line.startswith("#"))


def warm(case, tmp, device):
    """One untimed process over the worklist's first 6 events: the first
    process on a machine builds the kernels (nvcc) and the BAM codec
    (g++), which later processes load."""
    head = os.path.join(tmp, "warm.bed")
    with open(case["bed"]) as fh, open(head, "w") as fo:
        fo.writelines(line for line, _ in zip(fh, range(6)))
    run_all([(cli_cmd(dict(case, bed=head), os.path.join(tmp, "figs_w"),
                      os.path.join(tmp, "warm.vapor"),
                      os.path.join(tmp, "warm.txt"), device),
              one_thread_env())])


def two_ranks(case, tmp, device, tag="dist"):
    """A concurrent 2-rank run; (slower rank's seconds, merged output)."""
    out = os.path.join(tmp, f"{tag}.vapor")
    tfile = os.path.join(tmp, f"{tag}.txt")
    port = str(free_port())
    run_all([(cli_cmd(case, os.path.join(tmp, f"figs_{tag}{rank}"), out,
                      tfile, device),
              one_thread_env(RANK=str(rank), LOCAL_RANK=str(rank),
                             WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                             MASTER_PORT=port))
             for rank in range(2)])
    return max(times(tfile)), out


def measure(case, tmp, device):
    warm(case, tmp, device)
    out1 = os.path.join(tmp, "single.vapor")
    tf1 = os.path.join(tmp, "t1.txt")
    run_all([(cli_cmd(case, os.path.join(tmp, "figs1"), out1, tf1, device),
              one_thread_env())])
    (t1,) = times(tf1)
    t2, out2 = two_ranks(case, tmp, device)
    same = rows(out1) == rows(out2)
    if not same:
        raise RuntimeError("the 2-rank output differs from the 1-process "
                           "output")
    n = case["n_events"]
    return {"procs": 2, "events": n, "device": device,
            "events_per_s_1proc": n / t1, "events_per_s_2proc": n / t2,
            "t_1proc_s": t1, "t_2proc_s": t2,
            "scaling_efficiency": t1 / (2.0 * t2),
            "rows_equal": same,
            "note": "2 torch.distributed ranks (gloo, contig-granular "
                    "shards, rank 0 merges); in-process wall from the "
                    "CLI's entry to the merged output; merged rows equal "
                    "to the 1-process run's"}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--contigs", type=int, default=8)
    ap.add_argument("--events-per", type=int, default=45)
    ap.add_argument("--reads-per", type=int, default=12)
    ap.add_argument("--contig-len", type=int, default=400000)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=os.path.join(
        REPO, "chiprun_out", "scaling_sim_torch.json"))
    args = ap.parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("scaling_sim_torch: no CUDA card (--device cpu runs on the "
              "CPU)", file=sys.stderr)
        return 1
    from vapor_tpu_torch.sim.scale import build_scale_case
    with tempfile.TemporaryDirectory(prefix="vapor_scaling_") as tmp:
        case = build_scale_case(tmp, n_contigs=args.contigs,
                                contig_len=args.contig_len,
                                events_per=args.events_per,
                                reads_per=args.reads_per, n_false_per=1,
                                seed=31)
        print(f"fixture: {case['n_events']} events, {case['n_reads']} "
              f"reads", file=sys.stderr)
        result = measure(case, tmp, args.device)
    if args.device == "cuda":
        from vapor_tpu_torch.engine.kernels.roofline import card_line
        result["card"] = card_line()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fo:
        json.dump(result, fo, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
