"""Spanning-read extraction, subsampling, multi-BAM resolution.

Mirrors the host-side read pipeline of the reference:
``bam_in_decide`` (pyx:69-89), ``chop_pacbio_read_by_pos`` (pyx:339-354),
``minimize_pacbio_read_list`` (pyx:1091-1102).
"""
from __future__ import annotations

import os
from functools import lru_cache
from typing import Dict, List

from ..utils import trace
from .bam import BamReader
from .cigar import clip_read_to_window


def resolve_bam_inputs(bam_in: str) -> List[str]:
    """Literal path, or a directory pattern with ``XXX``/``*`` wildcards.

    Port of ``bam_in_decide`` (pyx:69-89): all files in the parent
    directory sharing the pattern's extension and containing every
    fixed fragment of the name.
    """
    if os.path.isfile(bam_in):
        return [bam_in]
    parent = "/".join(bam_in.split("/")[:-1]) + "/"
    name = bam_in.split("/")[-1]
    if "XXX" in name:
        keys = name.split("XXX")
    elif "*" in name:
        keys = name.split("*")
    else:
        return []
    out = []
    ext = bam_in.split(".")[-1]
    try:
        listing = os.listdir(parent)
    except OSError:
        return []
    for candidate in listing:
        if candidate.split(".")[-1] == ext and all(
                k in candidate for k in keys):
            out.append(parent + candidate)
    return out


@lru_cache(maxsize=8)
def _open_bam(path: str):
    """Indexed reader when a .bai sits next to the BAM (no whole-file
    decompression), whole-file reader otherwise."""
    if os.path.exists(path + ".bai"):
        try:
            from .bai import IndexedBam
            return IndexedBam(path)
        except Exception:
            pass
    return BamReader(path)


def extract_spanning_reads(bam_path: str, chrom: str, start1: int, end1: int,
                           flank_length: int) -> List[List]:
    """All reads spanning the window, clipped — [[seq, miss_bp, name], ...].

    Output order matches ``samtools view`` region order (file order for a
    coordinate-sorted BAM), which the subsampler depends on.
    """
    out = []
    reader = _open_bam(bam_path)
    for rec in reader.fetch(chrom, start1, end1):
        with trace.span("reads.clip"):
            clipped = clip_read_to_window(rec, start1, end1, flank_length)
        if clipped is not None:
            out.append([clipped[0], clipped[1], rec.name])
    return out


def subsample_reads(reads: List[List], ideal_list_length: int = 20
                    ) -> List[List]:
    """Cap at ``ideal_list_length`` reads preferring smallest miss_bp.

    Port of ``minimize_pacbio_read_list`` (pyx:1091-1102): group by
    miss_bp, take groups in ascending miss_bp order until the cap, then
    truncate (insertion order preserved within groups).
    """
    if len(reads) <= ideal_list_length:
        return reads
    groups: Dict[int, List[List]] = {}
    for r in reads:
        groups.setdefault(r[1], []).append(r)
    out: List[List] = []
    for key in sorted(groups):
        if len(out) < ideal_list_length:
            out += groups[key]
    return out[:ideal_list_length]


def collect_event_reads(bam_in: str, chrom: str, start1: int, end1: int,
                        flank_length: int, ideal_list_length: int = 20
                        ) -> List[List]:
    """Multi-BAM read gather + subsample for one event window.

    Port of ``simple_chop_pacbio_read_simple_short`` /
    ``simple_del_chop_pacbio_read_simple_short`` (pyx:1378-1401).
    """
    paths = resolve_bam_inputs(bam_in)
    if not paths:
        return []
    reads: List[List] = []
    for p in paths:
        reads += extract_spanning_reads(p, chrom, start1, end1, flank_length)
    return subsample_reads(reads, ideal_list_length)
