"""VaPoR's k-mer recurrence scorers in numpy (frozen copy of the parts of
vapor_tpu_torch/engine/oracle.py that the validators of DEL, INS, INV and
tandem DUP reach, with its quirks: IUPAC codes collapse to N, the read
side is hashed on both strands, cluster membership is by offset value,
abs_dis_m1b uppercases and the others do not).

``ft`` is the floating type of every quantity that is not an integer
count: numpy float64 for the reference, float32 for the control.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import List, Sequence, Tuple

import numpy as np

_AMBIG = "RYSWKMBDHV"
_MODIFY_LUT = np.arange(256, dtype=np.uint8)
for _c in _AMBIG:
    _MODIFY_LUT[ord(_c)] = ord("N")
    _MODIFY_LUT[ord(_c.lower())] = ord("n")
_COMP = {"A": "T", "T": "A", "C": "G", "G": "C", "N": "N",
         "a": "t", "t": "a", "c": "g", "g": "c", "n": "n"}
_COMP_LUT = np.full(256, 0xFE, dtype=np.uint8)
for _src, _dst in _COMP.items():
    _COMP_LUT[ord(_src)] = ord(_dst)


def encode(seq: str) -> np.ndarray:
    return _MODIFY_LUT[np.frombuffer(seq.encode("latin-1"), dtype=np.uint8)]


def _window_ids(arrays: List[np.ndarray], k: int) -> List[np.ndarray]:
    views = []
    for c in arrays:
        n = len(c) - k + 1
        views.append(np.zeros((0, k), dtype=np.uint8) if n <= 0 else
                     np.lib.stride_tricks.sliding_window_view(c, k))
    flat = np.ascontiguousarray(np.concatenate(views, axis=0))
    if flat.shape[0] == 0:
        return [np.zeros(0, dtype=np.int64) for _ in arrays]
    voids = flat.view(np.dtype((np.void, k))).ravel()
    _, inv = np.unique(voids, return_inverse=True)
    out, o = [], 0
    for v in views:
        out.append(inv[o: o + v.shape[0]].astype(np.int64))
        o += v.shape[0]
    return out


def _match_pairs(hap_ids: np.ndarray, probe_ids: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    order = np.argsort(hap_ids, kind="stable").astype(np.int64)
    sh = hap_ids[order]
    lo = np.searchsorted(sh, probe_ids, side="left")
    hi = np.searchsorted(sh, probe_ids, side="right")
    counts = hi - lo
    total = int(counts.sum())
    if total == 0:
        return (np.zeros(0, dtype=np.int64),) * 2
    pp = np.repeat(np.arange(len(probe_ids), dtype=np.int64), counts)
    prefix = np.concatenate([[0], np.cumsum(counts)[:-1]])
    flat = np.repeat(lo, counts) + \
        (np.arange(total, dtype=np.int64) - np.repeat(prefix, counts))
    return order[flat], pp


def _void_windows(c: np.ndarray, k: int) -> np.ndarray:
    if len(c) - k + 1 <= 0:
        return np.zeros(0, dtype=np.dtype((np.void, k)))
    w = np.ascontiguousarray(np.lib.stride_tricks.sliding_window_view(c, k))
    return w.view(np.dtype((np.void, k))).ravel()


class HapKmerIndex:
    """Sorted k-mer windows of one haplotype, reused for every read."""

    def __init__(self, hap: str, k: int):
        self.k = k
        self.hap_len = len(hap)
        v = _void_windows(encode(hap), k)
        self.order = np.argsort(v, kind="stable").astype(np.int64)
        self.sorted = v[self.order]

    def _join(self, probe: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        lo = np.searchsorted(self.sorted, probe, side="left")
        hi = np.searchsorted(self.sorted, probe, side="right")
        counts = hi - lo
        total = int(counts.sum())
        if total == 0:
            return (np.zeros(0, dtype=np.int64),) * 2
        pp = np.repeat(np.arange(len(probe), dtype=np.int64), counts)
        prefix = np.concatenate([[0], np.cumsum(counts)[:-1]])
        flat = np.repeat(lo, counts) + (
            np.arange(total, dtype=np.int64) - np.repeat(prefix, counts))
        return self.order[flat], pp

    def dots(self, read: str, miss: int):
        k = self.k
        c1 = encode(read)
        n1 = len(c1)
        mj = n1 - k + 1
        z = np.zeros(0, dtype=np.int64)
        if mj <= 0 or self.hap_len - miss - k + 1 <= 0:
            return z, z, z
        fi, fj = self._join(_void_windows(c1, k))
        ri, rp = self._join(_void_windows(_COMP_LUT[c1][::-1], k))
        rj = (n1 - k) - rp
        i_all = np.concatenate([fi, ri])
        j_all = np.concatenate([fj, rj])
        sel = i_all >= miss
        keys = (i_all[sel] - miss) * mj + j_all[sel]
        if keys.size == 0:
            return z, z, z
        uniq, ww = np.unique(keys, return_counts=True)
        return uniq // mj, uniq % mj, ww.astype(np.int64)


class HapCache:
    """The last 16 haplotype indexes, per reference object."""

    def __init__(self):
        self._cache: "OrderedDict" = OrderedDict()

    def get(self, hap: str, k: int) -> HapKmerIndex:
        idx = self._cache.get((hap, k))
        if idx is None:
            idx = self._cache[hap, k] = HapKmerIndex(hap, k)
            if len(self._cache) > 16:
                self._cache.popitem(last=False)
        return idx


def dot_arrays(k: int, seq1: str, seq2: str):
    """(ii, jj, ww, n2, n1): forward and inverted k-mer dots of seq1
    (read side) against seq2 (haplotype side)."""
    c1 = encode(seq1)
    c2 = encode(seq2)
    n1, n2 = len(c1), len(c2)
    mi, mj = n2 - k + 1, n1 - k + 1
    if mi <= 0 or mj <= 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, z, n2, n1
    rc1 = _COMP_LUT[c1][::-1]
    hap_ids, fwd_ids, rc_ids = _window_ids([c2, c1, rc1], k)
    fi, fj = _match_pairs(hap_ids, fwd_ids)
    ri, rp = _match_pairs(hap_ids, rc_ids)
    rj = (n1 - k) - rp
    keys = np.concatenate([fi * mj + fj, ri * mj + rj])
    if keys.size == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, z, n2, n1
    uniq, ww = np.unique(keys, return_counts=True)
    return uniq // mj, uniq % mj, ww.astype(np.int64), n2, n1


def _kept_value_mask(values, weights, gap: int, keep_threshold: int,
                     fallback_to_max: bool) -> np.ndarray:
    if values.size == 0:
        return np.zeros(0, dtype=bool)
    uniq, inv = np.unique(values, return_inverse=True)
    counts = np.zeros(uniq.size, dtype=np.int64)
    np.add.at(counts, inv, weights)
    new_seg = np.ones(uniq.size, dtype=bool)
    new_seg[1:] = (uniq[1:] - uniq[:-1]) >= gap
    seg_id = np.cumsum(new_seg) - 1
    seg_total = np.zeros(seg_id[-1] + 1, dtype=np.int64)
    np.add.at(seg_total, seg_id, counts)
    kept_seg = seg_total > keep_threshold
    if fallback_to_max and not kept_seg.any():
        kept_seg = seg_total == seg_total.max()
    return kept_seg[seg_id][inv]


def clean_mask_diag_and_anti(ii, jj, ww) -> np.ndarray:
    kept_d = _kept_value_mask(jj - ii, ww, 10, 10, False)
    kept_a = _kept_value_mask(jj + ii, ww, 10, 10, False)
    return kept_d | kept_a


def clean_mask_within10(ii, jj, ww) -> np.ndarray:
    if ii.size == 0:
        return np.zeros(0, dtype=bool)
    kept_d = _kept_value_mask(jj - ii, ww, 10, 50, True)
    left = ~kept_d
    kept_a_left = np.zeros_like(kept_d)
    if left.any():
        kept_a_left[left] = _kept_value_mask((jj + ii)[left], ww[left],
                                             10, 50, True)
    return kept_d | kept_a_left


def eu_dis_abs(ii, jj, ww, ft):
    """mean |i - j| over dots (pyx:705-708)."""
    total = ft(np.sum(ww))
    return ft(np.sum((np.abs(ii - jj) * ww).astype(ft), dtype=ft)) / total


def eu_dis_dir(i0, i1, ww, ft):
    """mean (i0 - i1) over dots deviating >10% (pyx:718-722)."""
    denom = np.where(i0 == 0, i0 + 1, i0)
    sel = np.abs((i0 - i1) / denom) > ft(0.1)
    wsel = ww * sel
    total = ft(np.sum(wsel))
    if total == 0:
        return ft(0.0001)
    return ft(np.sum(((i0 - i1) * wsel).astype(ft), dtype=ft)) / total


def eu_dis_within_10perc(ii, jj, ww, ft) -> int:
    """count of dots with i>0 and |i-j|/i < 0.16 (pyx:730-733)."""
    pos = ii > 0
    dev = np.zeros(ii.shape, dtype=ft)
    dev[pos] = np.abs((ii[pos] - jj[pos]).astype(ft) / ii[pos].astype(ft))
    return int(np.sum(ww * (pos & (dev < ft(0.16)))))


def _number_cluster(sorted_vals: np.ndarray, edges: Sequence[float]
                    ) -> List[np.ndarray]:
    bins: List[List[float]] = [[] for _ in edges]
    reca, recb = 0, 1
    vals = sorted_vals.tolist()
    while True:
        if reca == len(vals) or recb == len(edges):
            break
        if vals[reca] < edges[recb]:
            bins[recb - 1].append(vals[reca])
            reca += 1
        else:
            recb += 1
    if reca < len(vals):
        bins[-1].extend(vals[reca:])
    return [np.asarray(b, dtype=sorted_vals.dtype) for b in bins]


def _find_longest(bins: List[np.ndarray]) -> List[np.ndarray]:
    top = max(b.size for b in bins)
    out: List[np.ndarray] = []
    for b in bins:
        if b.size == top and not any(
                b.size == o.size and np.array_equal(b, o) for o in out):
            out.append(b)
    return out


def most_abundant_intercept(ii, jj, ww, ft):
    """dis_to_diagnal_most_abundant_defined (pyx:582-591)."""
    d = np.repeat(jj - ii, ww).astype(ft)
    d.sort()
    lo, hi = d[0], d[-1]
    edges = [lo + ft(t) * (hi - lo) / ft(10.0) for t in range(11)]
    kept1 = _find_longest(_number_cluster(d, edges))
    kept2: List[np.ndarray] = []
    for km in kept1:
        if km.size == 0:
            kept2.extend(_find_longest(_number_cluster(km, [ft(0.0)] * 11)))
            continue
        jlo, jhi = km.min(), km.max()
        sub_edges = [jlo + ft(t) * (jhi - jlo) / ft(10.0)
                     for t in range(11)]
        kept2.extend(_find_longest(_number_cluster(np.sort(km), sub_edges)))
    if len(kept2) == 1:
        return ft(np.median(kept2[0]))
    return ft(0.0)


class DotSet:
    __slots__ = ("ii", "jj", "ww", "n_dots", "i_min", "i_max", "hap_len")

    def __init__(self, index: HapKmerIndex, read: str, miss: int):
        self.ii, self.jj, self.ww = index.dots(read, miss)
        self.n_dots = int(self.ww.sum()) if self.ww.size else 0
        self.i_min = int(self.ii.min()) if self.ii.size else 0
        self.i_max = int(self.ii.max()) if self.ii.size else 0
        self.hap_len = max(0, index.hap_len - miss)

    @property
    def span(self) -> int:
        return self.i_max - self.i_min


class Scorers:
    """The three scorers the CLI's DEL, INS, INV and DUP paths use, each
    returning [ref_metric, alt_metric] (within_10perc: [alt, ref])."""

    def __init__(self, ft=np.float64):
        self.ft = ft
        self.haps = HapCache()

    def _pair(self, k, read, miss, ref_seq, alt_seq):
        return (DotSet(self.haps.get(ref_seq, k), read, miss),
                DotSet(self.haps.get(alt_seq, k), read, miss))

    def abs_dis_m1b(self, ref_seq, alt_seq, read, miss, window):
        """pyx:182-203."""
        ft = self.ft
        ref_seq, alt_seq = ref_seq.upper(), alt_seq.upper()
        r, a = self._pair(window, read, miss, ref_seq, alt_seq)
        if not (r.n_dots > 2 and a.n_dots > 2):
            return [0, 0]
        if not r.n_dots / min(len(ref_seq), len(alt_seq)) > 0.1:
            return [0, 0]
        r_ok = r.span / len(ref_seq) > 0.6
        a_ok = a.span / len(alt_seq) > 0.6
        if not (r_ok and a_ok):
            if r_ok:
                return [1.1, 2.1]
            if a_ok:
                return [2.1, 1.1]
            return [0, 0]
        rm = clean_mask_diag_and_anti(r.ii, r.jj, r.ww)
        am = clean_mask_diag_and_anti(a.ii, a.jj, a.ww)
        if rm.any() and am.any():
            return [eu_dis_abs(r.ii[rm], r.jj[rm], r.ww[rm], ft),
                    eu_dis_abs(a.ii[am], a.jj[am], a.ww[am], ft)]
        return [0, 0]

    def within_10perc_m1b(self, ref_seq, alt_seq, read, miss, window):
        """pyx:277-294; returns [alt, ref]."""
        ft = self.ft
        r, a = self._pair(window, read, miss, ref_seq, alt_seq)
        if not max(r.n_dots / len(ref_seq), a.n_dots / len(alt_seq)) > 0.1:
            return [0, 0]
        rm = clean_mask_within10(r.ii, r.jj, r.ww)
        am = clean_mask_within10(a.ii, a.jj, a.ww)
        if rm.any() and am.any():
            return [eu_dis_within_10perc(a.ii[am], a.jj[am], a.ww[am], ft),
                    eu_dis_within_10perc(r.ii[rm], r.jj[rm], r.ww[rm], ft)]
        return [0, 0]

    def redefine_diagonal(self, ref_seq, alt_seq, read, miss, window):
        """pyx:241-257."""
        ft = self.ft
        r, a = self._pair(window, read, miss, ref_seq, alt_seq)
        if not (r.n_dots / len(ref_seq) > 0.1 and
                a.n_dots / len(alt_seq) > 0.1):
            return [0, 0]
        if not (r.span / len(ref_seq) > 0.7 and
                a.span / len(alt_seq) > 0.7):
            return [0, 0]
        rm = clean_mask_diag_and_anti(r.ii, r.jj, r.ww)
        am = clean_mask_diag_and_anti(a.ii, a.jj, a.ww)
        if not (rm.any() and am.any()):
            return [0, 0]
        out = []
        for ds, m in ((r, rm), (a, am)):
            c = most_abundant_intercept(ds.ii[m], ds.jj[m], ds.ww[m], ft)
            i0 = ds.ii[m].astype(ft) + c
            i1 = ds.jj[m].astype(ft)
            out.append(abs(eu_dis_dir(i0, i1, ds.ww[m], ft)))
        return out
