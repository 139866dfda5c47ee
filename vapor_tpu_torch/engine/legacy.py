"""Legacy engine components kept for inventory completeness.

These are present in the reference but off every CLI hot path; they ship
as host-side (numpy/scipy) utilities, differential-tested where the
reference is deterministic:

* edit distance — pyx:665-703 (the fuzzy k-mer path for windows > 40,
  unreachable because the adaptive window caps at 40);
* KDE-mode y/x ratio regression + directed metrics — pyx:718-786;
* per-region / dup-block directed distances — pyx:735-766;
* line recognizers over dot clouds — pyx:593-604, 851-854, 1120-1136,
  1176-1201, 1472-1481;
* dot-dump debug helpers — pyx:1693-1699, 2048-2052.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


def edit_distance(seq1: str, seq2: str) -> float:
    """Unit-cost Levenshtein distance (pyx:665-703, iterative form)."""
    n1, n2 = len(seq1), len(seq2)
    prev = np.arange(n2 + 1, dtype=np.float64)
    for r in range(1, n1 + 1):
        cur = np.empty(n2 + 1)
        cur[0] = r
        c1 = seq1[r - 1]
        for c in range(1, n2 + 1):
            cur[c] = min(cur[c - 1] + 1, prev[c] + 1,
                         prev[c - 1] + (0 if c1 == seq2[c - 1] else 1))
        prev = cur
    return float(prev[n2])


# --- directed / regression metrics (pyx:705-786) ---------------------------

def eu_dis_single_dot(dot) -> float:
    if dot[0] == 0:
        return abs(float(dot[0] - dot[1]) / float(dot[0] + 1))
    return abs(float(dot[0] - dot[1]) / float(dot[0]))


def eu_dis_dir_calcu(dots: Sequence) -> float:
    vals = [d[0] - d[1] for d in dots if eu_dis_single_dot(d) > 0.1]
    if not vals:
        return 0.0001
    return float(np.mean(vals))


def _unify(vals):
    out = []
    for v in vals:
        if v not in out:
            out.append(v)
    return out


def eu_y_vs_x_ratio_calcu(dots: Sequence) -> float:
    """Gaussian-KDE mode of per-dot y/x ratios (pyx:768-786)."""
    import scipy.optimize
    import scipy.stats
    ratios = [round(1.0 if d[0] == 0 else abs(float(d[1]) / float(d[0])),
                    2)
              for d in dots if eu_dis_single_dot(d) < 0.15]
    if not ratios:
        return 1
    if len(_unify(ratios)) > 1:
        density = scipy.stats.gaussian_kde(ratios)
        mode = scipy.optimize.fmin(lambda x: -density.pdf(x), 1, disp=0)
        if abs(mode[0] - 1) < 0.15:
            return mode[0]
        return 1
    return _unify(ratios)[0]


def eu_dis_reg_calcu(dots: Sequence) -> float:
    """|mean| of ratio-regressed deviations (pyx:724-728)."""
    ratio = eu_y_vs_x_ratio_calcu(dots)
    vals = [ratio * d[0] - d[1] for d in dots
            if eu_dis_single_dot([ratio * d[0], d[1]]) > 0.15]
    if not vals:
        return 0.0001
    return abs(float(np.mean(vals)))


def eu_dis_region_calcu(dots: Sequence, bps: Sequence[int]) -> float:
    """Per-breakpoint-region directed means (pyx:735-754); the stray
    stdout print of the region vector is preserved as the reference's
    only 'trace' output."""
    rel = [b - bps[0] for b in bps]
    regions: List[List] = [[] for _ in range(len(rel) - 1)]
    reca = recb = 0
    while True:
        if reca == len(dots) or recb == len(regions):
            break
        if dots[reca][0] < rel[recb + 1]:
            regions[recb].append(dots[reca])
            reca += 1
        else:
            recb += 1
    if reca < len(dots):
        regions[-1] += list(dots[reca:])
    out = [eu_dis_dir_calcu(r) for r in regions]
    print(out)
    strong = [v for v in out if abs(v) > 1]
    if not strong:
        return 0.0001
    return float(np.mean(strong))


def eu_dis_reg_dup_block_calcu(dots: Sequence,
                               dup_block_bps: Sequence) -> float:
    """pyx:756-766."""
    regions: List[List] = [[], [], []]
    for d in dots:
        if not d[0] < dup_block_bps[0][0] and not d[0] > dup_block_bps[0][1]:
            regions[0].append(d)
        elif not d[0] < dup_block_bps[1][0] and \
                not d[0] > dup_block_bps[1][1]:
            regions[1].append(d)
        else:
            regions[2].append(d)
    out = [eu_dis_dir_calcu(r) for r in regions]
    out[-1] = abs(out[-1])
    strong = [v for v in out if abs(v) > 1]
    if not strong:
        return 0.0001
    return float(np.mean(strong))


# --- line recognizers (pyx:593-604, 851-854, 1120-1136, 1176-1201) ---------

def one_dimension_cluster_by_gap(vals: Sequence[int], gap: int,
                                 min_len: int) -> List[List[int]]:
    """Positions of value-clusters with > min_len members (pyx:1120)."""
    positions = {}
    for i, v in enumerate(vals):
        positions.setdefault(v, []).append(i)
    keys = sorted(positions)
    groups = [[keys[0]]] if keys else []
    for k in keys[1:]:
        if k - groups[-1][-1] > gap:
            groups.append([k])
        else:
            groups[-1].append(k)
    out = []
    for g in groups:
        members = []
        for k in g:
            members += positions[k]
        if len(members) > min_len:
            out.append(members)
    return out


def dot_to_line(dots: Sequence, gap: int = 50, length: int = 10
                ) -> List[List]:
    """Recognize line segments in a dot cloud (pyx:593-604)."""
    d_vals = [d[1] - d[0] for d in dots]
    clusters = one_dimension_cluster_by_gap(d_vals, gap, length)
    segs = []
    for cl in clusters:
        sub = [dots[i] for i in cl]
        a_vals = [d[1] + d[0] for d in sub]
        for cl2 in one_dimension_cluster_by_gap(a_vals, gap, length):
            run = [sub[i] for i in cl2]
            segs.append([run[0], run[-1]])
    return segs


def kept_line_size_ok(seg, square_size: int = 400) -> bool:
    """pyx:851-854."""
    return abs((seg[1][0] - seg[0][0]) * (seg[1][1] - seg[0][1])) \
        > square_size


def ref_ref_deviate_lines(dots: Sequence) -> List[List]:
    """Off-diagonal line segments of a self-dotplot (pyx:1176-1187)."""
    kept = [d for d in dots if eu_dis_single_dot(d) > 0 and d[1] > d[0]]
    wings = dot_to_line(kept)
    mirrored = []
    for seg in wings:
        mirrored.append(seg)
        mirrored.append([[p[1], p[0]] for p in seg])
    oriented = []
    for seg in mirrored:
        if seg[0][0] < seg[1][0]:
            oriented.append(seg)
        else:
            oriented.append([seg[1], seg[0]])
    return [s for s in oriented if kept_line_size_ok(s)]


# --- debug dumps (pyx:1693-1699, 2048-2052) --------------------------------

def write_dotdata(path: str, dots: Sequence) -> None:
    with open(path, "w") as fo:
        for d in dots:
            fo.write(" ".join(str(v) for v in d) + "\n")


def write_ref_alt_dotdata(stem: str, ref_dots: Sequence,
                          alt_dots: Sequence) -> None:
    with open(stem + ".ref", "w") as fo:
        for d in ref_dots:
            fo.write("\t".join(str(v) for v in d) + "\n")
    with open(stem + ".alt", "w") as fo:
        for d in alt_dots:
            fo.write("\t".join(str(v) for v in d) + "\n")


def two_dimension_cluster_by_gap(dim1: Sequence[int],
                                 dim2: Sequence[int], gap: int,
                                 min_len: int) -> List[List[int]]:
    """Two-pass 1-D gap clustering (pyx:1472-1481)."""
    first = one_dimension_cluster_by_gap(dim1, gap, min_len)
    out: List[List[int]] = []
    for grp in first:
        out += one_dimension_cluster_by_gap([dim2[i] for i in grp],
                                            gap, min_len)
    return out


def take_off_symmetric_dots(dots: Sequence) -> List:
    """Drop mirror-symmetric dot pairs (pyx:1458-1470, legacy)."""
    half = len(dots) // 2
    left = [dots[i] for i in range(half)]
    right = [dots[len(dots) - 1 - i][::-1] for i in range(half)]
    left_dev = [d for d in left if eu_dis_single_dot(d) > 0.15]
    right_dev = [d for d in right if eu_dis_single_dot(d) > 0.15]
    sym = []
    for a in left_dev:
        for b in right_dev:
            if abs(a[0] - b[0]) < 6 and abs(a[1] - b[1]) < 6:
                sym.append(a)
                sym.append(b[::-1])
    return [d for d in dots if d not in sym]


def quality_filter(hits: Sequence) -> List:
    """Hard-coded slope band filter of the legacy figure path
    (pyx:1027-1039)."""
    slope1 = 1.0e6 / (825000 - 48000)
    slope2 = 1.0e6 / (914000 - 141000)
    offset1 = 0 - slope1 * 48000
    offset2 = 0 - slope2 * 141000
    return [h for h in hits
            if slope2 * h[0] + offset2 < h[1] < slope1 * h[0] + offset1]


def dup_inv_ref_alt_bps(sv_info: Sequence, flank_length: int,
                        alt_structure: Sequence[str]) -> List[List[int]]:
    """Breakpoint ladders of the DUP_INV ref/alt haplotypes
    (pyx:527-535, unused by the live validator but inventoried)."""
    bp_info = sorted(list(sv_info[1:3]) + [sv_info[4]])
    from ..grammar.letters import bp_to_block_len
    block_len = bp_to_block_len([sv_info[0]] + bp_info)
    ref_bps = [bp_info[0] - flank_length] + bp_info + \
        [bp_info[-1] + flank_length]
    alt_bps = ref_bps[:2]
    for unit in alt_structure:
        alt_bps.append(alt_bps[-1] + block_len[unit[0]])
    alt_bps.append(alt_bps[-1] + flank_length)
    return [ref_bps, alt_bps]


def dup_inv_dup_bps(sv_info: Sequence, flank_length: int,
                    alt_structure: Sequence[str]) -> List[List[int]]:
    """Duplicated-block coordinate pairs on the ALT (pyx:537-543)."""
    ref_bps, alt_bps = dup_inv_ref_alt_bps(sv_info, flank_length,
                                           alt_structure)
    rel = [b - alt_bps[0] for b in alt_bps]
    if len(alt_structure) == 2:
        return [rel[1:3], rel[2:4]]
    return [rel[1:3], rel[3:5]]
