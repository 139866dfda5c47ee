#!/usr/bin/env python3
"""Virtual multi-host scaling curve of vapor_tpu_torch: 1/2/4/8 shards,
and the balance of an imbalanced worklist.

Each shard of N runs ALONE, as a bed CLI process with --shard-by-contig
--shard-index p --num-shards N on the card (the port's shard
assignment, parallel/multihost.py shard_worklist: cost-weighted contig
packing), with one compute thread.  The virtual N-host wall is the
longest shard's in-process wall (from the CLI's entry to its return:
distinct hosts would run the shards at once, with nothing shared), and
efficiency_N = t_1 / (N x max shard wall).  At every N the shards' rows
together must equal the 1-process rows, and a real concurrent 2-rank
run (torch.distributed, gloo, scripts/scaling_sim_torch.py) must give
the 1-process rows too.  An untimed process builds the kernels and the
BAM codec first, so no shard's wall holds the build.

What a shard pays whatever its events is measured apart: a CLI process
over an empty worklist, and one shard of the largest N under cProfile.

An imbalanced worklist (3 contigs, the first keeping every event and the
others every 4th) compares the greedy packing's largest shard with a
round robin of contigs over 2 hosts, and times its 1 and 2 shards.

The worklists are vapor_tpu_torch/sim/scale.py build_scale_case (seed
31 balanced, 32 imbalanced, one false call per contig).

    python3 scripts/scaling_curve_torch.py [--procs 1,2,4,8]
        [--contigs 8] [--events-per 24] [--reads-per 12]
        [--contig-len 250000] [--device cuda|cpu]
        [--out chiprun_out/scaling_curve_torch.json]
"""
import argparse
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from scaling_sim_torch import (cli_cmd, one_thread_env, rows,  # noqa: E402
                               run_all, times, two_ranks, warm)


def events_of(bed_path):
    with open(bed_path) as fh:
        return [line.split("\t") for line in fh if line.strip()]


def assignment_balance(events, nprocs):
    """(greedy largest shard, round-robin largest shard, ideal) in
    events: the port's shard_worklist against contigs dealt in turn."""
    from vapor_tpu_torch.parallel.multihost import shard_worklist
    greedy = max(len(shard_worklist(events, p, nprocs))
                 for p in range(nprocs))
    contigs = []
    for e in events:
        if e[0] not in contigs:
            contigs.append(e[0])
    rr_of = {c: i % nprocs for i, c in enumerate(contigs)}
    rr_counts = [0] * nprocs
    for e in events:
        rr_counts[rr_of[e[0]]] += 1
    return greedy, max(rr_counts), len(events) / nprocs


def skew(bed_path):
    """Keeps every chr1 event of the bed and every 4th of the others."""
    with open(bed_path) as fh:
        lines = [line for line in fh if line.strip()]
    kept, nth = [], {}
    for line in lines:
        c = line.split("\t")[0]
        nth[c] = nth.get(c, 0) + 1
        if c == "chr1" or nth[c] % 4 == 0:
            kept.append(line)
    with open(bed_path, "w") as fo:
        fo.writelines(kept)


def curve_point(case, nprocs, tmp, tag, device):
    """Each shard of nprocs alone, in turn: (max shard wall, the shards'
    rows sorted, each shard's wall)."""
    walls, got = [], []
    for p in range(nprocs):
        out = os.path.join(tmp, f"{tag}_p{p}of{nprocs}.vapor")
        tf = os.path.join(tmp, f"{tag}_t{p}of{nprocs}.txt")
        extra = ["--shard-by-contig", "--shard-index", str(p),
                 "--num-shards", str(nprocs)] if nprocs > 1 else []
        run_all([(cli_cmd(case, os.path.join(tmp, f"figs_{tag}_{p}"), out,
                          tf, device, extra), one_thread_env())])
        (wall,) = times(tf)
        walls.append(wall)
        got += rows(out)
    return max(walls), sorted(got), walls


def fixed_cost(case, tmp, device, nprocs):
    """What a shard pays whatever its events: the in-process wall of a
    CLI process over an empty worklist (no event, no launch), and shard
    0 of nprocs again under cProfile (its top 30 entries by cumulative
    time)."""
    empty = os.path.join(tmp, "empty.bed")
    open(empty, "w").close()
    tf = os.path.join(tmp, "empty.txt")
    run_all([(cli_cmd(dict(case, bed=empty), os.path.join(tmp, "figs_e"),
                      os.path.join(tmp, "empty.vapor"), tf, device),
              one_thread_env())])
    pfile = os.path.join(tmp, "shard0.prof.txt")
    tfp = os.path.join(tmp, "shard0.prof.t")
    extra = ["--shard-by-contig", "--shard-index", "0", "--num-shards",
             str(nprocs)] if nprocs > 1 else []
    run_all([(cli_cmd(case, os.path.join(tmp, "figs_p"),
                      os.path.join(tmp, "shard0.prof.vapor"), tfp, device,
                      extra, pfile=pfile), one_thread_env())])
    with open(pfile) as fh:
        top = fh.read()
    return {"empty_worklist_s": times(tf)[0],
            "profiled_shard": {"shard": f"0 of {nprocs}",
                               "wall_s_under_cprofile": times(tfp)[0],
                               "top_cumulative": top}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", default="1,2,4,8")
    ap.add_argument("--contigs", type=int, default=8)
    ap.add_argument("--events-per", type=int, default=24)
    ap.add_argument("--reads-per", type=int, default=12)
    ap.add_argument("--contig-len", type=int, default=250000)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=os.path.join(
        REPO, "chiprun_out", "scaling_curve_torch.json"))
    args = ap.parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("scaling_curve_torch: no CUDA card (--device cpu runs on the "
              "CPU)", file=sys.stderr)
        return 1
    from vapor_tpu_torch.sim.scale import build_scale_case
    procs_list = [int(x) for x in args.procs.split(",")]
    with tempfile.TemporaryDirectory(prefix="vapor_curve_") as tmp:
        case = build_scale_case(tmp, n_contigs=args.contigs,
                                contig_len=args.contig_len,
                                events_per=args.events_per,
                                reads_per=args.reads_per, n_false_per=1,
                                seed=31)
        events = events_of(case["bed"])
        print(f"fixture: {len(events)} events over {args.contigs} contigs",
              file=sys.stderr)
        warm(case, tmp, args.device)
        t1, rows1, _ = curve_point(case, 1, tmp, "b1", args.device)
        points = {"1": {"wall_s": t1, "efficiency": 1.0}}
        for n in procs_list:
            if n == 1:
                continue
            tn, rows_n, walls = curve_point(case, n, tmp, f"b{n}",
                                            args.device)
            if rows_n != rows1:
                raise RuntimeError(f"shard rows differ at N={n}")
            g, rr, ideal = assignment_balance(events, n)
            points[str(n)] = {
                "wall_s": tn, "efficiency": t1 / (n * tn),
                "shard_walls_s": walls, "max_shard_events_greedy": g,
                "max_shard_events_roundrobin": rr,
                "ideal_events_per_shard": ideal}
            print(f"N={n}: wall={tn:.3f}s eff={t1 / (n * tn):.3f} "
                  f"shards {[round(w, 3) for w in walls]}", file=sys.stderr)
        fixed = fixed_cost(case, tmp, args.device, max(procs_list))
        print(f"fixed cost: empty worklist {fixed['empty_worklist_s']:.3f} "
              f"s in the CLI", file=sys.stderr)
        t2, out2 = two_ranks(case, tmp, args.device)
        if rows(out2) != rows1:
            raise RuntimeError("the concurrent 2-rank rows differ from the "
                               "1-process rows")
        concurrent = {"procs": 2, "wall_s": t2, "efficiency": t1 / (2 * t2),
                      "rows_equal": True}

        tmp2 = os.path.join(tmp, "imbalanced")
        os.makedirs(tmp2)
        big = build_scale_case(tmp2, n_contigs=3,
                               contig_len=args.contig_len * 2,
                               events_per=args.events_per * 2,
                               reads_per=args.reads_per, n_false_per=1,
                               seed=32)
        skew(big["bed"])
        imb_events = events_of(big["bed"])
        g2, rr2, ideal2 = assignment_balance(imb_events, 2)
        ti1, irows1, _ = curve_point(big, 1, tmp2, "i1", args.device)
        ti2, irows2, iwalls = curve_point(big, 2, tmp2, "i2", args.device)
        if irows1 != irows2:
            raise RuntimeError("imbalanced shard rows differ")
        imbalance = {
            "contigs": 3, "procs": 2, "events": len(imb_events),
            "wall_1proc_s": ti1, "wall_2proc_s": ti2,
            "efficiency": ti1 / (2 * ti2), "shard_walls_s": iwalls,
            "max_shard_events_greedy": g2,
            "max_shard_events_roundrobin": rr2,
            "ideal_events_per_shard": ideal2}
    result = {
        "harness": "each shard of N timed alone on the device (one compute "
                   "thread, in-process wall from the CLI's entry to its "
                   "return); wall_N = max(shard walls); shard rows equal "
                   "to the 1-process rows at every N; a concurrent 2-rank "
                   "torch.distributed run's merged rows equal too",
        "device": args.device, "events": len(events),
        "contigs": args.contigs, "points": points,
        "fixed_cost": fixed, "concurrent_2_ranks": concurrent,
        "imbalanced_case": imbalance}
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
