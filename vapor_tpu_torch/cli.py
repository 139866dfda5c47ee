"""Command-line interface: ``python -m vapor_tpu_torch bed ...``.

The argument surface is vapor-tpu's (reference ``vapor`` script,
vapor:287-296, plus the framework flags), with ``--device {cuda,cpu}``
and ``--backend {torch,numpy}``.  This slice of the port runs the ``bed``
subcommand; ``vcf``, ``ins``, ``svelter``, ``pdf`` and ``scatter`` exit
with code 2, as do ``--shard-by-contig`` and ``--trace``.

Flow quirks preserved from the reference: DEL/INV rows are keyed
``chrom:start:end:TYPE`` and scored events append to the output in
worklist order.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from . import vapor_version
from .config import DEFAULT_CONFIG
from .io.parsers import bed_info_readin
from .stats.genotype import organize_result
from .validators import ValidatorContext
from .writers.tsv import append_result_row, initiate_output

PORTED_MODES = ("bed",)


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
                        choices=["torch", "numpy"],
                        help="scoring backend (default: torch)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="device of the torch backend (default: cuda; "
                             "a missing card is an error)")
    parser.add_argument("--no-figures", action="store_true",
                        help="skip per-event recurrence-plot PNGs")
    parser.add_argument("--trace", action="store_true",
                        help="per-stage timing to stderr (not ported yet)")
    parser.add_argument("--shard-index", type=int, default=0,
                        help="worklist shard to process")
    parser.add_argument("--num-shards", type=int, default=1,
                        help="total worklist shards (round robin)")
    parser.add_argument("--shard-by-contig", action="store_true",
                        help="contig-granular shards (not ported yet)")
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


def _resume_keys(out_name: str):
    """Keys of events already written (checkpoint/resume support)."""
    done = set()
    if os.path.exists(out_name):
        with open(out_name) as fin:
            for line in fin:
                if line.startswith("#") or not line.strip():
                    continue
                cols = line.split("\t")
                done.add(":".join(cols[:4]) if len(cols) >= 10
                         else cols[0])
    return done


def run_bed(args, ctx: ValidatorContext, num_reads_cff: int,
            fig_ext: str = "png") -> None:
    from .utils.coro import run_pipelined
    out_path = _path_modify(args.output_path)
    os.makedirs(out_path, exist_ok=True)
    out_name = args.output_file
    sample = _sample_name(args.sv_input)
    events = bed_info_readin(args.sv_input)
    if args.num_shards > 1:
        events = [x for i, x in enumerate(events)
                  if i % args.num_shards == args.shard_index]
    done = _resume_keys(out_name) if args.resume else set()
    if not (args.resume and os.path.exists(out_name)):
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
                scores = yield from ctx.validate_del_gen(
                    num_reads_cff, x[:-3],
                    out_path + sample + ".DEL." + key.replace(":", "__")
                    + "." + fig_ext)
            elif x[-1] in ("a/a^", "a^/a", "a^/a^", "INV"):
                key = ":".join([str(i) for i in x[:-3]] + ["INV"])
                scores = yield from ctx.validate_inv_gen(
                    num_reads_cff, x[:-3],
                    out_path + sample + ".INV." + key.replace(":", "__")
                    + "." + fig_ext)
            elif x[-1] == "INS":
                key = ":".join([str(i) for i in x[:-3] + ["INS"]])
                ins_pos = "_".join(str(i) for i in x[:2])
                ins_seq = "X" * x[4] if isinstance(x[4], int) else x[4]
                scores = yield from ctx.validate_ins_gen(
                    num_reads_cff, ins_pos, ins_seq, "+",
                    out_path + sample + ".INS." + key.replace(":", "__")
                    + "." + fig_ext)
            elif x[-1] in ("a/aa", "aa/a", "aa/aa", "DUP", "TANDUP"):
                key = ":".join([str(i) for i in x[:-3]] + ["TANDUP"])
                scores = yield from ctx.validate_tandup_gen(
                    num_reads_cff, x[:-3],
                    out_path + sample + ".TANDUP."
                    + key.replace(":", "__") + "." + fig_ext)
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

    run_pipelined(tasks, emit, args.pipeline)


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    unported = [flag for flag, on in (
        (args.mode, args.mode not in PORTED_MODES),
        ("--shard-by-contig", args.shard_by_contig),
        ("--trace", args.trace)) if on]
    if unported:
        print(f"vapor-tpu-torch: {', '.join(unported)}: not ported yet",
              file=sys.stderr)
        return 2
    num_reads_cff = int(args.PB_supp) if args.PB_supp else \
        DEFAULT_CONFIG.num_reads_cff
    if not os.path.exists(args.reference):
        print(f"vapor-tpu-torch: reference FASTA not found: "
              f"{args.reference}", file=sys.stderr)
        return 2
    if not os.path.exists(args.sv_input):
        print(f"vapor-tpu-torch: SV input not found: {args.sv_input}",
              file=sys.stderr)
        return 2
    try:
        ctx = ValidatorContext(args.reference, args.pacbio_input,
                               backend=args.backend, device=args.device,
                               figures=not args.no_figures)
    except RuntimeError as exc:      # CUDA asked for and absent
        print(f"vapor-tpu-torch: {exc}", file=sys.stderr)
        return 2
    run_bed(args, ctx, num_reads_cff, fig_ext=args.figure_format)
    return 0


if __name__ == "__main__":
    sys.exit(main())
