"""Command-line interface: ``python -m vapor_tpu_torch {bed,vcf,ins,
svelter,pdf,scatter} ...``.

The argument surface is vapor-tpu's (reference ``vapor`` script,
vapor:287-296, plus the framework flags), with ``--device {cuda,cpu}``
and ``--backend {torch,torch-nobatch,torch-v1,numpy}``.  Scale-out:

* ``scatter`` splits the worklist by contig and runs one
  ``python -m vapor_tpu_torch`` process per contig (``--jobs`` at a
  time, on the same backend and device; shard n on ``cuda:{n % cards}``),
  then merges (orchestrate.py);
* under torchrun (WORLD_SIZE > 1) each rank joins a gloo process group,
  scores its contig-granular shard on ``cuda:{LOCAL_RANK % cards}``,
  writes ``<output>.shard<rank>`` and rank 0 writes the merged output
  (parallel/multihost.py);
* ``--shard-index/--num-shards`` take one shard by hand: round robin, or
  the multi-process assignment with ``--shard-by-contig``.

Flow quirks preserved from the reference:
* DEL/INV rows are keyed ``chrom:start:end:TYPE`` and scored events
  append to the output in worklist order;
* VCF mode writes to ``<sv-input>.vapor`` whatever --output-file says and
  then rewrites that file as an annotated VCF (vapor:385, 466);
* DEL/INV spans < 50 bp emit NA rows, with the sub-50 INV row labeled
  DEL (vapor:393-397, 408-412);
* svelter mode appends without writing a header (vapor:492);
* ``ins`` (MELT) mode works as vapor_pdf:43-108 describes (the
  reference CLI's ins branch is broken: vapor:310).
"""
from __future__ import annotations

import argparse
import atexit
import functools
import os
import sys
from typing import List, Optional

from . import vapor_version
from .config import DEFAULT_CONFIG
from .io.parsers import (bed4_info_readin, bed_info_readin, melt_records,
                         svelter_readin, vcf_list_readin)
from .stats.genotype import organize_result
from .utils import trace
from .utils.coro import run_pipelined
from .validators import ValidatorContext
from .writers.tsv import append_result_row, initiate_output
from .writers.vcf import annotate_vcf, invert_record_keys


def _path_modify(path: str) -> str:
    return path if path.endswith("/") else path + "/"


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="vapor-tpu-torch",
        description="Long-read validation of structural variants on a "
                    "CUDA card (VaPoR-compatible)")
    parser.add_argument("--version", action="version",
                        version=vapor_version)
    parser.add_argument("mode", choices=["bed", "vcf", "ins", "svelter",
                                         "pdf", "scatter"])
    parser.add_argument("--sv-input", required=True,
                        help="input file of SV calls (or MELT prefix)")
    parser.add_argument("--reference", required=True,
                        help="reference sequences")
    parser.add_argument("--pacbio-input", required=True,
                        help="input pacbio sequences in bam format")
    parser.add_argument("--output-path", required=True,
                        help="path of output VaPoR figures")
    parser.add_argument("--output-file", required=False, default="",
                        help="name of output file")
    parser.add_argument("--PB-supp", required=False,
                        help="minimum number of evaluable PacBio reads")
    parser.add_argument("--backend", default="torch",
                        choices=["torch", "torch-nobatch", "torch-v1",
                                 "numpy"],
                        help="scoring backend (default: torch, the fused "
                             "engine with cross-event batching and the "
                             "device window refiner; torch-nobatch "
                             "launches each request on its own; torch-v1 "
                             "is the v1 dense engine)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="device of the torch backend (default: cuda; "
                             "a missing card is an error)")
    parser.add_argument("--no-figures", action="store_true",
                        help="skip per-event recurrence-plot PNGs")
    parser.add_argument("--trace", action="store_true",
                        help="at exit, print to stderr each span's count, "
                             "total and self time, the counters and each "
                             "kernel's launches")
    parser.add_argument("--shard-index", type=int, default=0,
                        help="worklist shard to process (multi-host)")
    parser.add_argument("--num-shards", type=int, default=1,
                        help="total worklist shards (multi-host)")
    parser.add_argument("--shard-by-contig", action="store_true",
                        help="use the contig-granular balanced shard "
                             "assignment of multi-process runs for manual "
                             "--shard-index runs")
    parser.add_argument("--resume", action="store_true",
                        help="skip events already present in the output "
                             "file (preemption-safe restart)")
    parser.add_argument("--figure-format", default="png",
                        choices=["png", "pdf"],
                        help="recurrence-plot format")
    parser.add_argument("--sv-type", default=None,
                        help="pdf mode: only validate this SV type")
    parser.add_argument("--size-cff", type=int, default=0,
                        help="pdf mode: minimum SV span")
    parser.add_argument("--scatter-mode", default="bed",
                        choices=["bed", "vcf"],
                        help="scatter mode: worklist format")
    parser.add_argument("--jobs", type=int, default=1,
                        help="scatter mode: concurrent shard processes")
    parser.add_argument("--pipeline", type=int, default=24,
                        help="overlap host prep and device scoring "
                             "across N events (output order unchanged; "
                             "--pipeline 1 processes events strictly in "
                             "sequence)")
    parser.add_argument("--validate-vcf-tandup", action="store_true",
                        help="vcf mode: score DUP/TANDUP records")
    return parser


def _sample_name(path: str) -> str:
    return ".".join(path.split("/")[-1].split(".")[:-1])


def _shard(items: List, index: int, total: int,
           dist: bool = False, owner=None) -> List:
    """Worklist shard: manual --shard-index keeps plain round robin;
    multi-process runs (and --shard-by-contig) go contig-granular
    (parallel.multihost) so per-process BAM regions stay disjoint.
    ``owner`` shares one assignment across several per-type calls (vcf
    mode: it must come from the combined event list, or the same contig
    could be owned by different shards for different SV types)."""
    if total <= 1:
        return list(items)
    if dist:
        from .parallel.multihost import shard_worklist
        return shard_worklist(items, index, total, owner=owner)
    return [x for i, x in enumerate(items) if i % total == index]


def _dist_out(out_name: str, dist) -> str:
    """Per-process output file in a multi-process run."""
    return out_name + (f".shard{dist[0]}" if dist else "")


def _dist_finalize(local_out: str, final_out: str, dist) -> None:
    """Gathers every process's result rows and writes the merged output
    on rank 0: the in-job replacement for the WDL ConcatVaPoR file merge
    (TasksBenchmark.wdl:249-317).  The gather doubles as the end-of-run
    barrier.  Nothing to do in a single-process run (dist None)."""
    if not dist:
        return
    from .orchestrate import _version_key
    from .parallel.multihost import allgather_rows
    header = None
    rows: List[List[str]] = []
    if os.path.exists(local_out):
        with open(local_out) as fin:
            for line in fin:
                if line.startswith("#"):
                    header = header or line
                    continue
                if line.strip():
                    rows.append(line.rstrip("\n").split("\t"))
    merged = allgather_rows(rows)
    if dist[0] == 0:
        merged.sort(key=lambda r: (
            _version_key(r[0]),
            int(r[1]) if len(r) > 1 and r[1].lstrip("-").isdigit()
            else 0))
        with open(final_out, "w") as fo:
            if header:
                fo.write(header)
            for r in merged:
                fo.write("\t".join(r) + "\n")


def _resume_keys(out_name: str):
    """Keys of events already written (checkpoint/resume support).  A
    last line without its newline, left by a run killed mid-write, is cut
    off the file, so its event is scored again and the next row starts
    on a line of its own."""
    done = set()
    if os.path.exists(out_name):
        with open(out_name, "rb+") as fh:
            data = fh.read()
            whole = data.rfind(b"\n") + 1
            if whole < len(data):
                fh.truncate(whole)
        for line in data[:whole].decode().splitlines():
            if line.startswith("#") or not line.strip():
                continue
            cols = line.split("\t")
            done.add(":".join(cols[:4]) if len(cols) >= 10 else cols[0])
    return done


def plan_bed(args, ctx: ValidatorContext, num_reads_cff: int,
             fig_ext: str = "png", bed4: bool = False):
    """(tasks, emit, finish) of a bed run: the event generators for
    run_pipelined, the row writer, and what follows the last row."""
    out_path = _path_modify(args.output_path)
    os.makedirs(out_path, exist_ok=True)
    dist = args.dist
    final_out = args.output_file
    out_name = _dist_out(final_out, dist)
    sample = _sample_name(args.sv_input)
    if bed4:
        events = bed4_info_readin(args.sv_input)
        if args.sv_type:
            structure_label = {
                "/a": "DEL", "a/a^": "INV", "a/aa": "TANDUP",
                "INS": "INS"}
            events = [x for x in events
                      if args.sv_type in structure_label.get(
                          str(x[-1]), str(x[-1]))]
        if args.size_cff:
            events = [x for x in events
                      if not isinstance(x[1], str)
                      and x[2] - x[1] >= args.size_cff]
    else:
        events = bed_info_readin(args.sv_input)
    events = _shard(events, args.shard_index, args.num_shards,
                    dist=bool(dist) or args.shard_by_contig)
    done = _resume_keys(out_name) if args.resume else set()
    if not (args.resume and os.path.exists(out_name) and
            os.path.getsize(out_name)):
        initiate_output(out_name)
    type_label = {"a/": "DEL", "/a": "DEL", "/": "DEL", "DEL": "DEL",
                  "a/a^": "INV", "a^/a": "INV", "a^/a^": "INV",
                  "INV": "INV", "INS": "INS", "a/aa": "TANDUP",
                  "aa/a": "TANDUP", "aa/aa": "TANDUP", "DUP": "TANDUP",
                  "TANDUP": "TANDUP"}
    tasks = []
    for x in events:
        if done:
            label = type_label.get(x[-1])
            pre_key = ":".join(str(i) for i in list(x[:3]) + [label])
            if label and pre_key in done:
                continue

        def task(x=x):
            if x[-1] in ("a/", "/a", "/", "DEL"):
                key = ":".join([str(i) for i in x[:-3]] + ["DEL"])
                scores = yield from trace.stepped(
                    "validate.del", ctx.validate_del_gen(
                        num_reads_cff, x[:-3],
                        out_path + sample + ".DEL."
                        + key.replace(":", "__") + "." + fig_ext))
            elif x[-1] in ("a/a^", "a^/a", "a^/a^", "INV"):
                key = ":".join([str(i) for i in x[:-3]] + ["INV"])
                scores = yield from trace.stepped(
                    "validate.inv", ctx.validate_inv_gen(
                        num_reads_cff, x[:-3],
                        out_path + sample + ".INV."
                        + key.replace(":", "__") + "." + fig_ext))
            elif x[-1] == "INS":
                key = ":".join([str(i) for i in x[:-3] + ["INS"]])
                ins_pos = "_".join(str(i) for i in x[:2])
                ins_seq = "X" * x[4] if isinstance(x[4], int) else x[4]
                scores = yield from trace.stepped(
                    "validate.ins", ctx.validate_ins_gen(
                        num_reads_cff, ins_pos, ins_seq, "+",
                        out_path + sample + ".INS."
                        + key.replace(":", "__") + "." + fig_ext))
            elif x[-1] in ("a/aa", "aa/a", "aa/aa", "DUP", "TANDUP"):
                key = ":".join([str(i) for i in x[:-3]] + ["TANDUP"])
                scores = yield from trace.stepped(
                    "validate.dup", ctx.validate_tandup_gen(
                        num_reads_cff, x[:-3],
                        out_path + sample + ".TANDUP."
                        + key.replace(":", "__") + "." + fig_ext))
            else:
                print(x)
                return None, None, None
            return key, x[3], scores
        tasks.append(task)

    def emit(key, svid, scores):
        if key is None:
            return
        result = organize_result(key, scores)
        append_result_row(out_name,
                          result[0].split(":") + [svid] + result[1:])
        print(result)

    return tasks, emit, functools.partial(_dist_finalize, out_name,
                                          final_out, dist)


def plan_vcf(args, ctx: ValidatorContext, num_reads_cff: int):
    out_path = _path_modify(args.output_path)
    os.makedirs(out_path, exist_ok=True)
    sample = _sample_name(args.sv_input)
    vcf_list, rec_hash = vcf_list_readin(args.sv_input)
    dist = args.dist
    final_out = args.sv_input + ".vapor"
    out_name = _dist_out(final_out, dist)
    initiate_output(out_name)

    def emit(key: Optional[str], scores) -> None:
        if key is None:
            return
        append_result_row(out_name, organize_result(key, scores))

    def fig(kind: str, key: str) -> str:
        return out_path + sample + "." + kind + "." + \
            key.replace(":", "__") + ".png"

    # one contig->shard assignment for ALL SV types: computed from the
    # combined event list so the same contig is never owned by
    # different shards for different types (per-process BAM disjointness)
    dist_mode = bool(dist) or args.shard_by_contig
    owner = None
    if dist_mode and args.num_shards > 1:
        from .parallel.multihost import balanced_owner
        owner = balanced_owner(
            [y for t in vcf_list for y in vcf_list[t] if "NA" not in y],
            args.num_shards)
    tasks = []
    for sv_type in list(vcf_list.keys()):
        for y in _shard(vcf_list[sv_type], args.shard_index,
                        args.num_shards, dist=dist_mode, owner=owner):
            if "NA" in y:
                continue

            def task(sv_type=sv_type, y=y):
                print(y)
                if sv_type == "DEL":
                    key = ":".join([str(i) for i in y] + ["DEL"])
                    if y[2] - y[1] < DEFAULT_CONFIG.min_sv_span:
                        return key, []
                    return key, (yield from trace.stepped(
                        "validate.del", ctx.validate_del_gen(
                            num_reads_cff, y, fig("DEL", key))))
                if sv_type == "INV":
                    if y[2] - y[1] < DEFAULT_CONFIG.min_sv_span:
                        # the reference labels the sub-50 INV NA row DEL
                        # (vapor:409)
                        return ":".join([str(i) for i in y]
                                        + ["DEL"]), []
                    key = ":".join([str(i) for i in y] + ["INV"])
                    return key, (yield from trace.stepped(
                        "validate.inv", ctx.validate_inv_gen(
                            num_reads_cff, y, fig("INV", key))))
                if sv_type == "INS":
                    key = ":".join([str(i) for i in y[:3] + ["INS"]])
                    ins_pos = "_".join(str(i) for i in y[:2])
                    # reference quirk (vapor:425-426): INS worklist
                    # entries always carry 4 fields, so a record
                    # without SEQ= gets an *empty* insert sequence
                    # (flank 0 -> NA), never the X-run fallback
                    ins_seq = y[-1] if len(y) == 4 else "X" * y[2]
                    return key, (yield from trace.stepped(
                        "validate.ins", ctx.validate_ins_gen(
                            num_reads_cff, ins_pos, ins_seq, "+",
                            fig("INS", key))))
                if sv_type == "DISDUP":
                    key = ":".join([str(i) for i in y] + ["DISDUP"])
                    return key, (yield from ctx.validate_disdup_gen(
                        num_reads_cff, y, fig("DISDUP", key)))
                if sv_type == "DEL_INV":
                    key = ":".join(["_".join(str(i) for i in blk)
                                    for blk in y] + ["DEL_INV"])
                    return key, (yield from ctx.validate_del_inv_gen(
                        num_reads_cff, y, fig("DEL_INV", key)))
                if sv_type == "DUP_INV":
                    key = ":".join([str(i) for i in y] + ["DUP_INV"])
                    return key, (yield from ctx.validate_dup_inv_gen(
                        num_reads_cff, y, fig("DUP_INV", key)))
                if sv_type == "TANDUP":
                    if args.validate_vcf_tandup:
                        key = ":".join([str(i) for i in y] + ["TANDUP"])
                        return key, (yield from trace.stepped(
                            "validate.dup", ctx.validate_tandup_gen(
                                num_reads_cff, y, fig("TANDUP", key))))
                    # reference quirk: the VCF flow has no TANDUP
                    # branch (vapor:387-465); DUP/tandup records are
                    # parsed but never validated and emit no row
                    print(sv_type)
                    return None, None
                if sv_type == "Other":
                    key = ":".join([str(i) for i in y]
                                   + ["CANNOT_CLASSIFY"])
                    return key, (yield from ctx.validate_complex_gen(
                        num_reads_cff, y, fig("CANNOT_CLASSIFY", key)))
                return None, None
            tasks.append(task)

    def finish():
        _dist_finalize(out_name, final_out, dist)
        if not dist or dist[0] == 0:
            annotate_vcf(args.sv_input, invert_record_keys(rec_hash))

    return tasks, emit, finish


def plan_ins(args, ctx: ValidatorContext, num_reads_cff: int):
    """MELT prefix mode (semantics of vapor_pdf:43-108)."""
    from .io.fasta import FastaFile
    out_path = _path_modify(args.output_path)
    os.makedirs(out_path, exist_ok=True)
    prefix = args.sv_input
    sample = prefix.split("/")[-1].split(".")[0]
    seq_fa = FastaFile(prefix + ".fa") if os.path.exists(prefix + ".fa") \
        else None

    def fetch_entry(name: str) -> str:
        if seq_fa is None or name not in seq_fa.references:
            return ""
        return seq_fa.fetch(name, 1, seq_fa.contig_length(name))

    dist = args.dist
    final_out = prefix + ".vapor"
    out_name = _dist_out(final_out, dist)
    initiate_output(out_name)
    records = _shard(melt_records(prefix, fetch_entry), args.shard_index,
                     args.num_shards, dist=bool(dist) or args.shard_by_contig)

    def task(key_event, ins_seq, polarity):
        return key_event, (yield from ctx.validate_ins_gen(
            num_reads_cff, key_event, ins_seq, polarity,
            out_path + sample + ".INS."
            + key_event.replace(":", "__") + ".png"))

    def emit(key_event, scores):
        append_result_row(out_name, organize_result(key_event, scores))

    return ([functools.partial(task, *rec) for rec in records], emit,
            functools.partial(_dist_finalize, out_name, final_out, dist))


def plan_svelter(args, ctx: ValidatorContext, num_reads_cff: int):
    out_path = _path_modify(args.output_path)
    os.makedirs(out_path, exist_ok=True)
    dist = args.dist
    out_name = _dist_out(args.output_file, dist)
    sample = _sample_name(args.sv_input)
    svelter_hash = svelter_readin(args.sv_input)
    tasks = []
    for ref_struct in list(svelter_hash.keys()):
        for alt_struct in list(svelter_hash[ref_struct].keys()):
            for bps in _shard(svelter_hash[ref_struct][alt_struct],
                              args.shard_index, args.num_shards,
                              dist=bool(dist) or args.shard_by_contig):

                def task(ref_struct=ref_struct, alt_struct=alt_struct,
                         bps=bps):
                    key_event = "." + "_".join(bps)
                    fig = out_path + sample + \
                        key_event.replace(":", "__") + ".png"
                    sv_info = [ref_struct, alt_struct] + bps
                    print(sv_info)
                    return key_event, (yield from ctx.validate_complex_gen(
                        num_reads_cff, sv_info, fig))
                tasks.append(task)

    def emit(key_event, scores):
        append_result_row(out_name, organize_result(key_event, scores))

    return tasks, emit, functools.partial(_dist_finalize, out_name,
                                          args.output_file, dist)


def main(argv: Optional[List[str]] = None) -> int:
    trace.memory("call.enter")
    trace.memory_by_path()
    try:
        return _main(argv)
    finally:
        trace.memory("call.exit")


def _main(argv: Optional[List[str]]) -> int:
    args = build_parser().parse_args(argv)
    # multi-process execution: under torchrun (WORLD_SIZE > 1) join the
    # gloo process group, take a contig-granular worklist shard on this
    # rank's card, and merge result rows by an allgather at the end (the
    # WDL scatter + ConcatVaPoR pattern, in-job).  A scatter shard takes
    # its card the same way.  No-op otherwise.
    from .parallel.multihost import (finalize, initialize, one_of_several,
                                     rank_device)
    pid, nproc = initialize()
    args.dist = None
    if nproc > 1:
        args.shard_index, args.num_shards = pid, nproc
        args.dist = (pid, nproc)
    if one_of_several():
        args.device = rank_device(args.device)
    try:
        return _run(args)
    finally:
        finalize()


def _run(args) -> int:
    num_reads_cff = int(args.PB_supp) if args.PB_supp else \
        DEFAULT_CONFIG.num_reads_cff
    if not os.path.exists(args.reference):
        print(f"vapor-tpu-torch: reference FASTA not found: "
              f"{args.reference}", file=sys.stderr)
        return 2
    if args.mode != "ins" and not os.path.exists(args.sv_input):
        print(f"vapor-tpu-torch: SV input not found: {args.sv_input}",
              file=sys.stderr)
        return 2
    if args.mode == "scatter":
        from .engine.scoring import get_backend
        from .orchestrate import run_scatter
        try:    # the shards' backend and device, checked here first
            get_backend(args.backend, args.device)
        except RuntimeError as exc:      # CUDA asked for and absent
            print(f"vapor-tpu-torch: {exc}", file=sys.stderr)
            return 2
        run_scatter(args.scatter_mode, args.sv_input, args.reference,
                    args.pacbio_input, args.output_path,
                    args.output_file, jobs=args.jobs,
                    backend=args.backend, device=args.device,
                    extra_args=[flag for flag, on in (
                        ("--no-figures", args.no_figures),
                        ("--trace", args.trace)) if on])
        return 0
    if args.trace:
        trace.enable()
        atexit.register(trace.report)
    with trace.span("cli.setup"):
        try:
            ctx = ValidatorContext(args.reference, args.pacbio_input,
                                   backend=args.backend, device=args.device,
                                   figures=not args.no_figures)
        except RuntimeError as exc:      # CUDA asked for and absent
            print(f"vapor-tpu-torch: {exc}", file=sys.stderr)
            return 2
        if args.mode == "bed":
            plan = plan_bed(args, ctx, num_reads_cff,
                            fig_ext=args.figure_format)
        elif args.mode == "pdf":
            # vapor_pdf twin: 4-column BED, default min-reads 10, PDF
            # figures, output written next to the input
            # (vapor_pdf:92-138)
            if not args.PB_supp:
                num_reads_cff = 10
            args.output_file = args.output_file or \
                args.sv_input + ".vapor"
            plan = plan_bed(args, ctx, num_reads_cff, fig_ext="pdf",
                            bed4=True)
        elif args.mode == "vcf":
            plan = plan_vcf(args, ctx, num_reads_cff)
        elif args.mode == "ins":
            plan = plan_ins(args, ctx, num_reads_cff)
        else:
            plan = plan_svelter(args, ctx, num_reads_cff)
    tasks, emit, finish = plan
    run_pipelined(tasks, trace.spanned("emit")(emit), args.pipeline)
    with trace.span("cli.finish"):
        finish()
    return 0


# before the port makes any CUDA call
trace.memory("import", once=True)

if __name__ == "__main__":
    sys.exit(main())
