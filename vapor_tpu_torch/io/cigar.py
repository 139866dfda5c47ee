"""CIGAR-driven read clipping with reference-exact semantics.

Reproduces ``cigar2alignstart_by_pos`` + ``chop_pacbio_read_by_pos``
(Simple_function.pyx:309-354) including their quirks:

* the CIGAR walk stops after the first op whose cumulative reference
  position exceeds ``start-1``; ``miss_bp`` is the overshoot unless that
  op was M/=, in which case the read offset is rewound and miss_bp is 0;
* reads whose alignment does not reach ``start`` get a *negative*
  miss_bp (the walk ran out of ops) and survive the miss_bp gate;
* only reads with POS <= start and at least ``end-start-miss_bp``
  clipped bases are kept.
"""
from __future__ import annotations

import re
from typing import List, Optional, Tuple

_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")


def cigar_align_start(cigar: str, pos1: int, start1: int) -> Tuple[int, int]:
    """(read_offset, miss_bp) for genomic position ``start1``.

    ``pos1`` is the 1-based alignment POS.  Port of pyx:309-337.
    """
    read_rec = 0
    align_rec = pos1
    last_op = ("", "")
    for m in _CIGAR_RE.finditer(cigar):
        n, op = int(m.group(1)), m.group(2)
        if op == "S":
            read_rec += n
        elif op in ("M", "="):
            read_rec += n
            align_rec += n
        elif op == "D":
            align_rec += n
        elif op == "I":
            read_rec += n
        last_op = (n, op)
        if align_rec > start1 - 1:
            break
    start_dis = align_rec - start1
    if last_op[1] in ("M", "="):
        return read_rec - start_dis, 0
    return read_rec, start_dis


def clip_read_to_window(seq: str, cigar: str, pos1: int,
                        start1: int, end1: int,
                        flank_length: int) -> Optional[List]:
    """Clip an aligned read to genomic window [start1, end1].

    Returns ``[clipped_seq, miss_bp, keep]`` semantics of pyx:339-354:
    None when the read fails the POS / miss_bp / length gates, else
    ``[clipped, miss_bp]``.
    """
    if not pos1 < start1 + 1:
        return None
    align_start, miss_bp = cigar_align_start(cigar, pos1, start1)
    if miss_bp > flank_length / 2:
        return None
    target = seq[align_start:]
    want = end1 - start1 - miss_bp
    if len(target) > want:
        return [target[:want], miss_bp]
    return None
