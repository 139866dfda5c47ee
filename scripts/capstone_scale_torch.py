"""At-scale capstone of vapor_tpu_torch on the card: a 24-contig,
1,056-event worklist through the bed subcommand, per-contig scatter,
and a scatter killed mid-run and resumed.

The worklist is vapor_tpu_torch/sim/scale.py build_scale_case (24
contigs x 400 kb, 42 events each: DEL, INV and tandem DUP of 150-700
bp, 16 reads per event of READ_LEN bp, half donor and half reference,
and 2 false calls per contig backed by reference reads; seed 77).
Reference analog: the per-contig WDL scatter over ~24 shards,
wdl/VaPoRVcf.wdl:44-85 and TasksBenchmark.wdl:249-317.  Three legs:

1. **throughput**: an untimed warm pass over a 24-event head of the
   worklist (it builds the kernels), then the full worklist, timed, in
   the same process, through the default backend with --pipeline 24;
   events/s, reads scored/s (per-read scores in VaPoR_Rec), each
   kernel's launches and the window refiner's BAND_STATS.
2. **scatter**: orchestrate.run_scatter over the 24 contigs on the
   card, --jobs processes at a time (one process per contig, each
   reaching the card on its own); its merged rows must equal leg 1's.
3. **resume**: leg 2 again in a subprocess, killed with SIGKILL (its
   whole process group: the scatter and its shard processes) once a
   third of the shards have finished, then rerun with --resume.  The
   merged output must equal leg 2's byte for byte, the shards finished
   before the kill must not be written again, and each row appears
   once.

    python3 scripts/capstone_scale_torch.py [--contigs 24]
        [--contig-len 400000] [--events-per 42] [--pipeline 24]
        [--jobs 4] [--device cuda] [--out chiprun_out/capstone_torch.json]
"""
import argparse
import contextlib
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _strip(path):
    """Output rows only, sorted (scatter shards re-sort; headers
    identical)."""
    with open(path) as fh:
        return sorted(line for line in fh
                      if line.strip() and not line.startswith("#"))


def _rows(path) -> int:
    if not os.path.exists(path):
        return 0
    with open(path) as fh:
        return sum(1 for line in fh
                   if line.strip() and not line.startswith("#"))


def reads_scored(path) -> int:
    """Per-read scores in the VaPoR_Rec column of a bed output."""
    n = 0
    for line in _strip(path):
        rec = line.rstrip("\n").split("\t")[-1]
        if rec not in ("NA", ""):
            n += len(rec.split(","))
    return n


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--contigs", type=int, default=24)
    ap.add_argument("--contig-len", type=int, default=400000)
    ap.add_argument("--events-per", type=int, default=42)
    ap.add_argument("--pipeline", type=int, default=24)
    ap.add_argument("--jobs", type=int, default=4,
                    help="scatter legs: shard processes at a time")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=os.path.join(
        REPO, "chiprun_out", "capstone_torch.json"))
    args = ap.parse_args()
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("capstone_scale_torch: no CUDA card (--device cpu runs on "
              "the CPU)", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory(prefix="vapor_capstone_") as tmp:
        report = run(args, tmp)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fo:
        json.dump(report, fo, indent=1)
    print(f"wrote {args.out}; ok {report['ok']}", flush=True)
    return 0 if report["ok"] else 1


def run(args, tmp):
    """The three legs in the directory tmp; returns the report."""
    import torch
    from vapor_tpu_torch.cli import main as cli_main
    from vapor_tpu_torch.engine import kernels, window_device
    from vapor_tpu_torch.sim.scale import build_scale_case

    def sync():
        if args.device == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    print(f"building {args.contigs} contigs x {args.contig_len} bp, "
          f"~{args.events_per} events each ...", flush=True)
    case = build_scale_case(tmp, n_contigs=args.contigs,
                            contig_len=args.contig_len,
                            events_per=args.events_per, reads_per=16)
    build_s = time.perf_counter() - t0
    n_events = case["n_events"]
    print(f"built: {n_events} events, {case['n_reads']} reads "
          f"({build_s:.1f} s)", flush=True)
    report = {"device": args.device,
              "card": torch.cuda.get_device_name(0)
              if args.device == "cuda" else None,
              "contigs": args.contigs, "contig_len": args.contig_len,
              "events": n_events, "reads": case["n_reads"],
              "build_s": build_s}

    # -- leg 1: one process, pipelined --------------------------------
    def run_cli(bed, out, tag):
        cli_args = ["bed", "--sv-input", bed, "--reference", case["fasta"],
                    "--pacbio-input", case["bam"],
                    "--output-path", os.path.join(tmp, f"figs_{tag}"),
                    "--output-file", out, "--device", args.device,
                    "--no-figures", "--pipeline", str(args.pipeline)]
        t0 = time.perf_counter()
        with open(os.devnull, "w") as devnull, \
                contextlib.redirect_stdout(devnull):
            rc = cli_main(cli_args)
        sync()
        if rc != 0:
            raise RuntimeError(f"bed CLI exited {rc} ({tag})")
        return time.perf_counter() - t0

    head_bed = os.path.join(tmp, "head.bed")
    with open(case["bed"]) as fh, open(head_bed, "w") as fo:
        fo.writelines(line for line, _ in zip(fh, range(24)))
    print("leg 1: warm pass (24-event head) ...", flush=True)
    warm_s = run_cli(head_bed, os.path.join(tmp, "head.vapor"), "warm")
    print("leg 1: timed pipelined run ...", flush=True)
    out1 = os.path.join(tmp, "pipeline.vapor")
    kernels.reset_counts()
    band0 = dict(window_device.BAND_STATS)
    wall1 = run_cli(case["bed"], out1, "timed")
    n_reads = reads_scored(out1)
    report["pipeline"] = {
        "backend": "torch", "pipeline": args.pipeline,
        "warm_s": warm_s, "wall_s": wall1,
        "rows": _rows(out1),
        "events_per_s": n_events / wall1,
        "reads_scored": n_reads, "reads_per_s": n_reads / wall1,
        "launches": dict(kernels.LAUNCHES),
        "band_stats": {k: window_device.BAND_STATS[k] - band0[k]
                       for k in band0}}
    print(json.dumps(report["pipeline"]), flush=True)
    if report["pipeline"]["rows"] != n_events:
        raise RuntimeError(f"{report['pipeline']['rows']} rows for "
                           f"{n_events} events")

    # -- leg 2: per-contig scatter on the card --------------------------
    def scatter(figs, out, resume):
        """A subprocess (a new session: a kill reaches its shards too)
        running run_scatter; stdout, every event's result, dropped."""
        code = ("import sys; sys.path.insert(0, %r);"
                "from vapor_tpu_torch.orchestrate import run_scatter;"
                "run_scatter('bed', %r, %r, %r, %r, %r, jobs=%d, device=%r,"
                " extra_args=['--no-figures']%s)"
                % (REPO, case["bed"], case["fasta"], case["bam"], figs, out,
                   args.jobs, args.device,
                   " + ['--resume']" if resume else ""))
        return subprocess.Popen([sys.executable, "-c", code],
                                stdout=subprocess.DEVNULL,
                                start_new_session=True)

    out2 = os.path.join(tmp, "scatter.vapor")
    print(f"leg 2: {args.contigs}-shard scatter, --jobs {args.jobs} ...",
          flush=True)
    t0 = time.perf_counter()
    if scatter(os.path.join(tmp, "figs2"), out2, False).wait() != 0:
        raise RuntimeError("scatter failed")
    wall2 = time.perf_counter() - t0
    report["scatter"] = {
        "jobs": args.jobs, "shards": args.contigs, "wall_s": wall2,
        "events_per_s": n_events / wall2,
        "merged_equals_pipeline": _strip(out1) == _strip(out2)}
    print(json.dumps(report["scatter"]), flush=True)

    # -- leg 3: kill mid-run, restart with --resume ---------------------
    print("leg 3: scatter, SIGKILL mid-run, resume ...", flush=True)
    figs3 = os.path.join(tmp, "figs3")
    out3 = os.path.join(tmp, "resume.vapor")
    sharddir = os.path.join(figs3, "shards")

    def shard_outs():
        if not os.path.isdir(sharddir):
            return []
        return sorted(os.path.join(sharddir, f) for f in os.listdir(sharddir)
                      if f.endswith(".out.vapor"))

    def finished(path):
        """Whether a shard's output holds a row for each of its events."""
        contig = os.path.basename(path)[:-len(".out.vapor")]
        with open(os.path.join(sharddir, f"{os.path.basename(case['bed'])}"
                               f".{contig}.bed")) as fh:
            want = sum(1 for line in fh if line.strip())
        return _rows(path) == want

    t0 = time.perf_counter()
    p = scatter(figs3, out3, True)
    try:
        while p.poll() is None:
            if sum(finished(x) for x in shard_outs()) >= args.contigs // 3:
                os.killpg(p.pid, signal.SIGKILL)
                break
            time.sleep(0.05)
        p.wait(timeout=600)
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
    t_kill = time.perf_counter() - t0
    killed = p.returncode == -signal.SIGKILL
    done_at_kill = {x: os.stat(x).st_mtime_ns for x in shard_outs()
                    if finished(x)}
    rows_at_kill = sum(_rows(x) for x in shard_outs())
    t0 = time.perf_counter()
    if scatter(figs3, out3, True).wait() != 0:
        raise RuntimeError("resumed scatter failed")
    t_resume = time.perf_counter() - t0
    with open(out2, "rb") as a, open(out3, "rb") as b:
        equal = a.read() == b.read()
    report["resume"] = {
        "killed_mid_run": killed and rows_at_kill < n_events,
        "shards_finished_at_kill": len(done_at_kill),
        "rows_at_kill": rows_at_kill,
        "wall_until_kill_s": t_kill,
        "wall_resumed_s": t_resume,
        "merged_equals_scatter_bytes": equal,
        "rows_once": _rows(out3) == n_events,
        "finished_shards_not_rewritten": all(
            os.stat(x).st_mtime_ns == m for x, m in done_at_kill.items())}
    print(json.dumps(report["resume"]), flush=True)
    report["ok"] = bool(report["scatter"]["merged_equals_pipeline"] and
                        all(report["resume"][k] for k in (
                            "killed_mid_run", "merged_equals_scatter_bytes",
                            "rows_once", "finished_shards_not_rewritten")))
    return report


if __name__ == "__main__":
    sys.exit(main())
