"""Scale-out orchestration: per-contig scatter + deterministic merge.

The reference scales via Cromwell/Terra WDL: SplitVcf/SplitBed per
contig, containerized `vapor bed` per shard, ConcatVaPoR
(zcat | sort -V | bgzip) to merge (wdl/VaPoRVcf.wdl:24-91,
TasksBenchmark.wdl:249-317, 739-828).  Here the same pattern is
internalized: split the worklist by contig, run each shard as a local
``python -m vapor_tpu_torch`` process on the same backend and device as
the caller (or hand shard IDs to separate hosts), and merge result rows
in deterministic (contig version-sort, position) order, optionally
BGZF-compressed with the framework's own codec.
"""
from __future__ import annotations

import os
import re
import subprocess
import sys
from typing import Dict, List, Optional, Sequence, Tuple


def split_by_contig(sv_input: str, out_dir: str) -> Dict[str, str]:
    """Split a BED or VCF worklist into per-contig files.

    VCF headers are replicated into every shard (SplitVcf semantics);
    BED shards are plain per-contig row subsets (SplitBed semantics).
    """
    os.makedirs(out_dir, exist_ok=True)
    is_vcf = sv_input.endswith(".vcf")
    header: List[str] = []
    rows: Dict[str, List[str]] = {}
    with open(sv_input) as fin:
        for line in fin:
            if is_vcf and line.startswith("#"):
                header.append(line)
                continue
            if not line.strip():
                continue
            contig = line.split()[0]
            rows.setdefault(contig, []).append(line)
    out: Dict[str, str] = {}
    ext = ".vcf" if is_vcf else ".bed"
    base = os.path.basename(sv_input)
    for contig, lines in rows.items():
        path = os.path.join(out_dir, f"{base}.{contig}{ext}")
        with open(path, "w") as fo:
            fo.writelines(header)
            fo.writelines(lines)
        out[contig] = path
    return out


def _version_key(token: str):
    """sort -V ordering used by ConcatVaPoR (TasksBenchmark.wdl:303)."""
    parts = re.split(r"(\d+)", token)
    return [int(p) if p.isdigit() else p for p in parts]


def merge_outputs(shard_outputs: Sequence[str], out_path: str,
                  compress: bool = False, index: bool = True) -> None:
    """Concat shard `.vapor` files: one header, rows sorted by
    (contig version-order, numeric position).  With compress=True the
    output is BGZF and (index=True) gets a tabix-compatible `.tbi`
    alongside, like the reference's ConcatVaPoR task
    (TasksBenchmark.wdl:303-309 bgzips then tabixes the concat)."""
    header: Optional[str] = None
    rows: List[List[str]] = []
    for path in shard_outputs:
        with open(path) as fin:
            for line in fin:
                if line.startswith("#"):
                    if header is None:
                        header = line
                    continue
                if line.strip():
                    rows.append(line.split("\t"))
    rows.sort(key=lambda r: (_version_key(r[0]),
                             int(r[1]) if len(r) > 1 and
                             r[1].lstrip("-").isdigit() else 0))
    text = (header or "") + "".join("\t".join(r) for r in rows)
    if compress:
        if index:
            from .io.tabix import write_bgzf_indexed
            write_bgzf_indexed(out_path, text)
            return
        from .io.bam import BGZF_EOF, _bgzf_compress_block
        data = text.encode()
        with open(out_path, "wb") as fo:
            for i in range(0, max(len(data), 1), 60000):
                chunk = data[i:i + 60000]
                if chunk:
                    fo.write(_bgzf_compress_block(chunk))
            fo.write(BGZF_EOF)
    else:
        with open(out_path, "w") as fo:
            fo.write(text)


def shard_jobs(mode: str, shards: Dict[str, str], reference: str,
               bam_in: str, work: str, backend: str = "torch",
               device: str = "cuda", extra_args: Sequence[str] = ()
               ) -> List[Tuple[List[str], Dict[str, str], str]]:
    """(command, environment, output file) of each shard process, one per
    contig of `shards` (contig -> its worklist file), in launch order
    (contig version order).  Shard n gets torchrun's LOCAL_RANK = n and
    LOCAL_WORLD_SIZE = the shard count: the CLI then runs it on card
    n % cards (parallel.multihost.rank_device) and keeps its rows there
    (parallel.mesh), so that concurrent shards spread over the cards
    instead of each splitting over all of them."""
    jobs = []
    items = sorted(shards.items(), key=lambda kv: _version_key(kv[0]))
    for n, (contig, shard_input) in enumerate(items):
        out = shard_input + ".vapor" if mode == "vcf" \
            else os.path.join(work, f"{contig}.out.vapor")
        cmd = [sys.executable, "-m", "vapor_tpu_torch", mode,
               "--sv-input", shard_input, "--reference", reference,
               "--pacbio-input", bam_in,
               "--output-path", os.path.join(work, f"figs_{contig}"),
               "--output-file", out,
               "--backend", backend, "--device", device] + \
            list(extra_args)
        env = dict(os.environ, LOCAL_RANK=str(n),
                   LOCAL_WORLD_SIZE=str(len(items)))
        jobs.append((cmd, env, out))
    return jobs


def run_scatter(mode: str, sv_input: str, reference: str, bam_in: str,
                output_path: str, output_file: str,
                jobs: int = 1, backend: str = "torch",
                device: str = "cuda",
                extra_args: Sequence[str] = ()) -> None:
    """Per-contig scatter of the CLI, merged into one output.  Every
    shard runs `backend` on `device` (CUDA unless the caller asks for
    the CPU), one card a shard (shard_jobs); raises when a shard
    fails."""
    work = os.path.join(output_path, "shards")
    procs: List = []
    outputs: List[str] = []
    for cmd, env, out in shard_jobs(mode, split_by_contig(sv_input, work),
                                    reference, bam_in, work, backend,
                                    device, extra_args):
        outputs.append(out)
        procs.append(subprocess.Popen(cmd, env=env))
        while len([p for p in procs if p.poll() is None]) >= jobs:
            for p in procs:
                if p.poll() is None:
                    p.wait()
                    break
    for p in procs:
        if p.wait() != 0:
            raise RuntimeError("scatter shard failed")
    merge_outputs([o for o in outputs if os.path.exists(o)],
                  output_file)
