"""Structure classifiers: decide whether a haplotype pair encodes a
simple DEL/INV/TANDUP/DISDUP.

Ports the legacy combinatorial classifiers
(Simple_function.pyx:1233-1376, 606-664, 2090-2099) used by SVelter-era
flows: given ref/alt structures like ``'ab/ab'`` vs ``'bab/ab'``, find
the duplicated blocks and insertion points (or reject with 'FALSE').
Held against the JAX package's copy in tests/test_torch_classify_prep.py.
"""
from __future__ import annotations

import itertools
from typing import List, Sequence, Union

from .letters import letter_subgroup

Result = Union[str, List]


def _intersect(a: str, b: str) -> str:
    return "".join(sorted(set(a) & set(b)))


def _max_interval_gap(codes: Sequence[int]) -> Union[int, str]:
    """interval_dis_calcu_max (pyx:843-849)."""
    if len(codes) > 1:
        return max(codes[i + 1] - codes[i] for i in range(len(codes) - 1))
    return "NA"


def simple_del_haploid(ref_hap: str, alt_hap: str) -> Result:
    """pyx:1244-1254."""
    if ref_hap == alt_hap:
        return "FALSE"
    if alt_hap == "":
        return [c for c in ref_hap]
    if "^" in alt_hap:
        return "FALSE"
    if max(alt_hap.count(c) for c in alt_hap) > 1:
        return "FALSE"
    if len(alt_hap) == 1 and len(ref_hap) > 1:
        return letter_subgroup(
            "".join(c for c in ref_hap if c not in alt_hap))
    gaps = [ord(alt_hap[i + 1]) - ord(alt_hap[i])
            for i in range(len(alt_hap) - 1)]
    if min(gaps) < 1:
        return "FALSE"
    return letter_subgroup("".join(c for c in ref_hap if c not in alt_hap))


def simple_inv_haploid(ref_hap: str, alt_hap: str) -> Result:
    """pyx:1267-1275."""
    if "^" not in alt_hap:
        return "FALSE"
    if len(alt_hap.replace("^", "")) == 1 and len(ref_hap) == 1:
        return [c for c in ref_hap]
    if max(alt_hap.count(c) for c in alt_hap if c != "^") > 1:
        return "FALSE"
    groups = letter_subgroup(alt_hap)
    if "".join(g.replace("^", "") for g in groups) == ref_hap:
        return [g[:-1] for g in groups if "^" in g]
    return "FALSE"


def simple_tandup_haploid(ref_hap: str, alt_hap: str) -> Result:
    """pyx:1288-1319."""
    if "^" in alt_hap:
        return "FALSE"
    counts = [alt_hap.count(c) for c in ref_hap]
    if min(counts) < 1 or max(counts) < 2:
        return "FALSE"
    runs: List[str] = []
    for c in alt_hap:
        if runs and ord(c) - ord(runs[-1][-1]) == 1:
            runs[-1] += c
        else:
            runs.append(c)
    out: List[str] = []
    overlap_portion: List[str] = []
    overlap_count: List[int] = []
    for run in runs:
        if not out:
            out.append(run)
            continue
        overlap = _intersect(out[-1], run)
        if not len(overlap) > len(out[-1]) and not len(overlap) > len(run):
            if out[-1][-len(overlap):] == run[: len(overlap)]:
                out[-1] += run[len(overlap):]
                if overlap not in overlap_portion:
                    overlap_portion.append(overlap)
                    overlap_count.append(2)
                else:
                    overlap_count[overlap_portion.index(overlap)] += 1
            else:
                out.append(run)
        else:
            out.append(run)
    if "".join(out) == ref_hap:
        return [overlap_portion, overlap_count]
    return "FALSE"


def dup_block_combine(dup_block: Sequence[str], ref_hap: str,
                      alt_hap: str) -> List[str]:
    """pyx:606-616: candidate duplicated multi-letter units."""
    combos: List[str] = []
    for n in range(len(dup_block)):
        combos += ["".join(c) for c in
                   itertools.combinations(dup_block, n + 1)]
    kept_contiguous = []
    for combo in combos:
        if len(combo) == 1:
            kept_contiguous.append(combo)
        else:
            codes = [ord(c) for c in combo]
            if _max_interval_gap(codes) == 1:
                kept_contiguous.append(combo)
    found = [c for c in kept_contiguous[::-1] if alt_hap.count(c) > 1]
    # drop units contained in an already-kept longer unit (pyx:629-639)
    kept: List[str] = []
    for unit in found:
        if not any(unit in longer for longer in kept):
            kept.append(unit)
    return kept[::-1]


def _expand_positions(positions: Sequence[int],
                      units: Sequence[str]) -> List[int]:
    """x_to_x_modify_new (pyx:2090-2099)."""
    out: List[int] = []
    for pos, unit in zip(positions, units):
        out.append(pos)
        out.extend(pos + 1 + i for i in range(len(unit) - 1))
    return out


def simple_disdup_haploid(ref_hap: str, alt_hap: str) -> Result:
    """pyx:1332-1376: dispersed-duplication detection."""
    if "^" in alt_hap:
        return "FALSE"
    if simple_tandup_haploid(ref_hap, alt_hap) != "FALSE":
        return "FALSE"
    groups = letter_subgroup(alt_hap)
    overlaps = [_intersect(groups[i], groups[i + 1])
                for i in range(len(groups) - 1)]
    uniq = []
    for o in overlaps:
        if o not in uniq:
            uniq.append(o)
    if len(uniq) != len(overlaps):
        return "FALSE"
    counts = [alt_hap.count(c) for c in ref_hap]
    if min(counts) < 1 or max(counts) < 2:
        return "FALSE"
    dup_block = [ref_hap[i] for i in range(len(counts)) if counts[i] > 1]
    units = dup_block_combine(dup_block, ref_hap, alt_hap)
    occurrences: List[List[int]] = []
    non_dup_positions = [alt_hap.index(c) for c in alt_hap
                         if c not in dup_block]
    for unit in units:
        occurrences.append([p for p in range(len(alt_hap) - len(unit) + 1)
                            if alt_hap[p: p + len(unit)] == unit])
    original_pos: List[int] = []
    for combo in itertools.product(*occurrences):
        expanded = _expand_positions(list(combo), units)
        structure = [alt_hap[i]
                     for i in sorted(expanded + non_dup_positions)]
        if "".join(structure) == ref_hap:
            original_pos += list(combo)
    if not original_pos:
        return "FALSE"
    insert_pos = [p for occ in occurrences for p in occ
                  if p not in original_pos]
    padded = ["-"] + list(alt_hap) + ["+"]
    insert_block: List[List[str]] = []
    for idx, p in enumerate(insert_pos):
        unit = units[idx] if idx < len(units) else units[-1]
        if len(unit) == 1:
            insert_block.append([padded[p], padded[p + 1], padded[p + 2]])
        else:
            insert_block.append([padded[p]] +
                                padded[p + 1: p + len(unit) + 2])
    return [units, insert_block]


def _diploid(fn, ref_struct: str, alt_struct: str) -> List[Result]:
    """Shared diploid wrapper (pyx:1233-1242 pattern)."""
    ref_hap = ref_struct.split("/")[0]
    out: List[Result] = []
    for alt_hap in alt_struct.split("/"):
        if alt_hap == ref_hap:
            out.append("NA")
        else:
            out.append(fn(ref_hap, alt_hap))
    return out


def simple_del_decide(ref_struct: str, alt_struct: str) -> List[Result]:
    return _diploid(simple_del_haploid, ref_struct, alt_struct)


def simple_inv_decide(ref_struct: str, alt_struct: str) -> List[Result]:
    return _diploid(simple_inv_haploid, ref_struct, alt_struct)


def simple_tandup_decide(ref_struct: str, alt_struct: str) -> List[Result]:
    return _diploid(simple_tandup_haploid, ref_struct, alt_struct)


def simple_disdup_decide(ref_struct: str, alt_struct: str) -> List[Result]:
    return _diploid(simple_disdup_haploid, ref_struct, alt_struct)
