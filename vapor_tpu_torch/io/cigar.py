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

A CIGAR is held as BAM stores it: a uint32 array of words
``length << 4 | op``, op indexing ``CIGAR_OPS``.  The walk and the
reference length are vector sums over those words; text is parsed
(``encode_cigar``) or rendered (``render_cigar``) only at the edges.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

CIGAR_OPS = "MIDNSHP=X"
_M, _EQ = CIGAR_OPS.index("M"), CIGAR_OPS.index("=")


def _op_table(ops: str) -> np.ndarray:
    table = np.zeros(16, np.int64)
    table[[CIGAR_OPS.index(op) for op in ops]] = 1
    return table


# the reference's walk advances the read on S, M, = and I and the
# alignment on M, = and D: X, N, H and P advance neither (its quirk)
_WALK_READ = _op_table("SM=I")
_WALK_ALIGN = _op_table("M=D")
# what htslib counts as the alignment's reference span
_REF_CONSUMING = _op_table("MDN=X")

_OP_CODE = np.zeros(256, np.uint32)
_OP_CODE[np.frombuffer(CIGAR_OPS.encode("ascii"), np.uint8)] = np.arange(
    len(CIGAR_OPS), dtype=np.uint32)
_POW10 = 10 ** np.arange(19, dtype=np.int64)


def encode_cigar(cigar: str) -> np.ndarray:
    """The uint32 words of a text CIGAR ("*" or "" for none)."""
    if cigar in ("", "*"):
        return np.empty(0, "<u4")
    b = np.frombuffer(cigar.encode("ascii"), np.uint8)
    is_op = b > 57                      # past '9': the op letters and '='
    at_op = np.flatnonzero(is_op)
    # each digit times 10 to the power of its distance to its op
    owner = np.cumsum(is_op) - is_op
    power = np.maximum(at_op[owner] - np.arange(len(b)) - 1, 0)
    digits = np.where(is_op, 0, b.astype(np.int64) - 48) * _POW10[power]
    starts = np.concatenate(([0], at_op[:-1] + 1))
    lengths = np.add.reduceat(digits, starts)
    return ((lengths << 4) | _OP_CODE[b[at_op]]).astype("<u4")


def render_cigar(words: np.ndarray) -> str:
    """The text form of CIGAR words ("*" for none)."""
    if len(words) == 0:
        return "*"
    return "".join([f"{n}{CIGAR_OPS[op]}" for n, op in zip(
        (words >> 4).tolist(), (words & 0xF).tolist())])


def ref_length(words: np.ndarray) -> int:
    """Reference bases the alignment consumes (M, D, N, = and X)."""
    w = words.astype(np.int64)
    return int(np.dot(w >> 4, _REF_CONSUMING[w & 0xF]))


def cigar_align_start(words: np.ndarray, pos1: int,
                      start1: int) -> Tuple[int, int]:
    """(read_offset, miss_bp) for genomic position ``start1``.

    ``pos1`` is the 1-based alignment POS.  Port of pyx:309-337 over
    CIGAR words: the walk's positions are two cumulative sums, and it
    stops at the first op whose alignment position passes start1 - 1,
    or at the last op where none does.
    """
    n = len(words)
    if n == 0:
        return 0, pos1 - start1
    w = words.astype(np.int64)
    op, length = w & 0xF, w >> 4
    align = np.cumsum(length * _WALK_ALIGN[op])
    k = min(int(np.searchsorted(align, start1 - 1 - pos1, side="right")),
            n - 1)
    read_rec = int(np.dot(length[:k + 1], _WALK_READ[op[:k + 1]]))
    start_dis = pos1 + int(align[k]) - start1
    if op[k] == _M or op[k] == _EQ:
        return read_rec - start_dis, 0
    return read_rec, start_dis


def clip_read_to_window(rec, start1: int, end1: int,
                        flank_length: int) -> Optional[List]:
    """Clip an aligned read (a ``BamRecord``) to genomic window
    [start1, end1].

    Returns ``[clipped_seq, miss_bp, keep]`` semantics of pyx:339-354:
    None when the read fails the POS / miss_bp / length gates, else
    ``[clipped, miss_bp]``.  Only the clipped bases are decoded: their
    bounds are the text's ``seq[align_start:][:want]``, Python's slice
    rules for any offset the walk gives included.
    """
    pos1 = rec.pos0 + 1
    if not pos1 < start1 + 1:
        return None
    align_start, miss_bp = cigar_align_start(rec.words, pos1, start1)
    if miss_bp > flank_length / 2:
        return None
    begin, stop, _ = slice(align_start, None).indices(rec.l_seq)
    want = end1 - start1 - miss_bp
    if stop - begin > want:
        _, cut, _ = slice(None, want).indices(stop - begin)
        return [rec.bases(begin, begin + cut), miss_bp]
    return None
