"""SV letter grammar — structures like ``ab/aba^`` over genomic blocks.

Blocks are letters a, b, c, ... each mapped to (chrom, start, end); ``^``
marks inversion; ``-``/``+`` are the left/right flanks.  Ports the pure
string/coordinate helpers of the reference (letter_split pyx:1013,
letter_subgroup pyx:993, bp_to_chr_hash pyx:98, block_around_check pyx:91,
block_subsplot pyx:147, block_modify pyx:123, bp_to_block_len pyx:116).
"""
from __future__ import annotations

from typing import Dict, List, Sequence


def letter_split(structure: str) -> List[str]:
    """'c^ba' -> ['c^', 'b', 'a'] (pyx:1013-1019)."""
    out: List[str] = []
    for ch in structure:
        if ch == "^":
            out[-1] += ch
        else:
            out.append(ch)
    return out


def letter_subgroup(structure: str) -> List[str]:
    """Group consecutive-letter runs, merging inverted runs in reverse
    order, e.g. 'ac^b^' -> ['a', 'bc^'] (pyx:993-1011)."""
    units = letter_split(structure)
    merged: List[str] = []
    for u in units:
        if not merged:
            merged.append(u)
        elif "^" not in merged[-1] and "^" not in u and \
                ord(u) - ord(merged[-1][-1]) == 1:
            merged[-1] += u
        elif "^" in merged[-1] and "^" in u and \
                ord(u[0]) - ord(merged[-1][-2]) == -1:
            merged[-1] += u
        else:
            merged.append(u)
    out = []
    for grp in merged:
        if "^" not in grp:
            out.append(grp)
        else:
            out.append(grp.replace("^", "")[::-1] + "^")
    return out


def block_around_check(alt_allele: str, ref_allele: str) -> List[List[str]]:
    """Junctions present in ALT but not REF (pyx:91-96).

    Each junction is a pair of adjacent units over '-' + units + '+'.
    NOTE (reference quirk kept): the REF junction list is truncated to
    the ALT's unit count, so extra REF junctions never suppress ALT ones.
    """
    alt_units = ["-"] + letter_split(alt_allele) + ["+"]
    ref_units = ["-"] + letter_split(ref_allele) + ["+"]
    n = len(letter_split(alt_allele)) + 1
    alt_juncs = [alt_units[j:j + 2] for j in range(n)]
    ref_juncs = [ref_units[j:j + 2] for j in range(n)]
    return [j for j in alt_juncs if j not in ref_juncs]


def block_subsplot(tokens: Sequence[str], chromos: Sequence[str]
                   ) -> List[List]:
    """Group ['chr1','100','200','chr2',...] into per-chrom coordinate
    lists [['chr1', 100, 200], ...] (pyx:147-153)."""
    out: List[List] = []
    for tok in tokens:
        if tok in chromos:
            out.append([tok])
        else:
            out[-1].append(int(tok))
    return out


def bp_to_chr_hash(bps: Sequence, chromos: Sequence[str],
                   flank_length: int = 500) -> Dict[str, List]:
    """Map letters -> (chrom, start, end) plus '-'/'+' flank blocks
    (pyx:98-114)."""
    grouped: List[List] = []
    for tok in bps:
        if str(tok) in chromos:
            grouped.append([tok])
        else:
            grouped[-1].append(tok)
    out: Dict[str, List] = {}
    rec = -1
    for grp in grouped:
        for k in range(len(grp[2:])):
            rec += 1
            out[chr(97 + rec)] = [grp[0], grp[k + 1], grp[k + 2]]
    last = sorted(k for k in out if k not in "+-")[-1]
    out["+"] = [out[last][0], out[last][2],
                str(int(out[last][2]) + flank_length)]
    out["-"] = [out["a"][0], str(int(out["a"][1]) - flank_length),
                int(out["a"][1])]
    return out


def bp_to_block_len(bp_info: Sequence) -> Dict[str, int]:
    """['chr1', s, m, e] -> {'a': m-s, 'b': e-m} (pyx:116-121)."""
    out = {}
    for i in range(len(bp_info) - 2):
        out[chr(97 + i)] = int(bp_info[i + 2]) - int(bp_info[i + 1])
    return out


def flank_length_calculate(bps: Sequence) -> int:
    """min(span, 500) with the reference's two-step form (pyx:794-802)."""
    span = int(bps[-1]) - int(bps[1])
    if span < 100:
        return span
    if span < 500:
        return span
    return 500
