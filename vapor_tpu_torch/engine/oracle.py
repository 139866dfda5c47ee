"""NumPy oracle for the dotplot scoring engine — exact reference semantics.

This module is the numerical ground truth for the CUDA kernels.  It
reimplements, in vectorized *sheared-coordinate* form, the behavior of the
reference's dict-based k-mer recurrence engine
(Simple_function.pyx: ``dotdata``/``kmerhits``/``subkeys`` :545-983,
cleaning :387-580, metrics :582-786, scorers :161-307), including its
quirks:

* IUPAC ambiguity codes collapse to N/n (``key_modify``, pyx:908) and the
  collapsed N *matches* other Ns — ambiguity is a real symbol, not a wildcard;
* the read side is hashed with forward *and* reverse-complement keys, so a
  palindromic read k-mer stores its position twice and matching dots are
  emitted with multiplicity 2;
* cluster membership is *by offset value*: every dot sharing a diagonal /
  anti-diagonal offset co-moves (``dis_cluster``/``dis_cluster_2``,
  pyx:551-580);
* ``dis_cluster`` keeps clusters of >50 dots, falling back to the largest
  cluster(s); ``dis_cluster_2`` keeps clusters of >10 dots with no fallback;
* case is significant except where a scorer explicitly uppercases
  (abs_dis_m1/m1b do, within_10Perc and the directed family do not).

A dot is (i, j) = (position in seq2, position in seq1) matching the
reference's ``hits.append((i, hit))`` orientation (pyx:979): in read
scoring seq1 = read and seq2 = haplotype, so dot[0] is the haplotype
coordinate.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

# --------------------------------------------------------------------------
# Sequence encoding
# --------------------------------------------------------------------------

# key_modify (pyx:908-949): IUPAC ambiguity -> N (case preserved).
_AMBIG = "RYSWKMBDHV"
_KEY_MODIFY = {}
for _c in _AMBIG:
    _KEY_MODIFY[_c] = "N"
    _KEY_MODIFY[_c.lower()] = "n"

_MODIFY_LUT = np.arange(256, dtype=np.uint8)
for _src, _dst in _KEY_MODIFY.items():
    _MODIFY_LUT[ord(_src)] = ord(_dst)

# invert_base (pyx:20) over the post-modify alphabet; characters outside it
# (e.g. 'X') get a non-matching sentinel — the reference would raise there,
# but 'X' never reaches the inverted-hash side in any CLI path (see
# window_size_refine X-stripping, pyx:2032, and the INS figure swap,
# pyx:1891).
_COMP = {"A": "T", "T": "A", "C": "G", "G": "C", "N": "N",
         "a": "t", "t": "a", "c": "g", "g": "c", "n": "n"}
_COMP_LUT = np.full(256, 0xFE, dtype=np.uint8)   # sentinel: matches nothing
for _src, _dst in _COMP.items():
    _COMP_LUT[ord(_src)] = ord(_dst)


def encode(seq: str) -> np.ndarray:
    """uint8 codes after key_modify collapse."""
    raw = np.frombuffer(seq.encode("latin-1"), dtype=np.uint8)
    return _MODIFY_LUT[raw]


def encode_comp(seq: str) -> np.ndarray:
    """Complement codes of the modified sequence (for inverted matches)."""
    return _COMP_LUT[encode(seq)]


# --------------------------------------------------------------------------
# Dot multiset
# --------------------------------------------------------------------------

def dot_weight_matrix(k: int, seq1: str, seq2: str
                      ) -> Tuple[np.ndarray, int, int]:
    """Weight matrix W[i, j] in {0,1,2} of k-mer matches.

    i indexes seq2 (haplotype side), j indexes seq1 (read side).
    W = forward match + inverted match, reproducing the emission
    multiset of ``kmerhits`` with ``nth_base=1, inversions=True``.
    """
    c1 = encode(seq1)
    c2 = encode(seq2)
    c1c = _COMP_LUT[c1]
    n1, n2 = len(c1), len(c2)
    mi, mj = n2 - k + 1, n1 - k + 1
    if mi <= 0 or mj <= 0:
        return np.zeros((max(mi, 0), max(mj, 0)), dtype=np.int8), n2, n1

    def windowed_and(match: np.ndarray) -> np.ndarray:
        """AND over k diagonal shifts by doubling (log k passes)."""
        pows = {1: match}
        cur, step = match, 1
        while step * 2 <= k:
            cur = cur[:-step, :-step] & cur[step:, step:]
            step *= 2
            pows[step] = cur
        out = None
        shift, rem = 0, k
        for step in sorted(pows, reverse=True):
            if step <= rem:
                part = pows[step][shift:shift + mi, shift:shift + mj]
                out = part.copy() if out is None else (out & part)
                shift += step
                rem -= step
        return out

    fwd = windowed_and(c2[:, None] == c1[None, :])
    # inverted: hap[i+s] == comp(read[j+k-1-s]) — flip the read axis of
    # the complement match so the run lies on a forward diagonal
    m2 = c2[:, None] == c1c[None, ::-1]
    inv = windowed_and(m2)[:, ::-1]
    return fwd.astype(np.int8) + inv.astype(np.int8), n2, n1


def dots_from_weights(W: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(i, j, w) arrays of nonzero dots, ordered by (i, j)."""
    ii, jj = np.nonzero(W)
    return ii.astype(np.int64), jj.astype(np.int64), \
        W[ii, jj].astype(np.int64)


def _window_ids(arrays: List[np.ndarray], k: int) -> List[np.ndarray]:
    """Integer ids of every length-k window of each code array, where
    equal windows (across all arrays) share an id.  Windows are compared
    as raw byte strings — exactly the equality the dense path tests."""
    views = []
    for c in arrays:
        n = len(c) - k + 1
        if n <= 0:
            views.append(np.zeros((0, k), dtype=np.uint8))
        else:
            views.append(np.lib.stride_tricks.sliding_window_view(c, k))
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
    """All (i, p) with hap_ids[i] == probe_ids[p] (sparse join)."""
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
    """Length-k windows of a code array as a sortable void array."""
    if len(c) - k + 1 <= 0:
        return np.zeros(0, dtype=np.dtype((np.void, k)))
    w = np.ascontiguousarray(np.lib.stride_tricks.sliding_window_view(c, k))
    return w.view(np.dtype((np.void, k))).ravel()


class HapKmerIndex:
    """Sorted k-mer window index of one haplotype, reused across every
    read of an event: ``dots(read, miss)`` equals
    ``dot_arrays(k, read, hap[miss:])`` exactly (the slice's windows are
    the full haplotype's windows at positions >= miss), but the
    O(H log H) haplotype sort is paid once instead of per read
    (tests/test_sparse_dots.py::test_hap_index_matches_slice)."""

    __slots__ = ("k", "hap_len", "order", "sorted")

    def __init__(self, hap: str, k: int):
        self.k = k
        self.hap_len = len(hap)
        v = _void_windows(encode(hap), k)
        self.order = np.argsort(v, kind="stable").astype(np.int64)
        self.sorted = v[self.order]

    def _join(self, probe: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray]:
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

    def dots(self, read: str, miss: int
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
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


_HAP_INDEX_CACHE: "OrderedDict" = None


def _hap_index(hap: str, k: int) -> HapKmerIndex:
    global _HAP_INDEX_CACHE
    if _HAP_INDEX_CACHE is None:
        from collections import OrderedDict
        _HAP_INDEX_CACHE = OrderedDict()
    key = (hap, k)
    idx = _HAP_INDEX_CACHE.get(key)
    if idx is None:
        idx = _HAP_INDEX_CACHE[key] = HapKmerIndex(hap, k)
        if len(_HAP_INDEX_CACHE) > 16:
            _HAP_INDEX_CACHE.popitem(last=False)
    return idx


def dot_arrays(k: int, seq1: str, seq2: str
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, int]:
    """Sparse-exact (ii, jj, ww, n2, n1): identical to
    ``dots_from_weights(dot_weight_matrix(k, seq1, seq2)[0])`` but built
    by k-mer id joins in O((|seq1|+|seq2|)·log + dots) instead of the
    dense O(|seq1|·|seq2|) windowed AND (tests/test_sparse_dots.py).

    Forward dot (i, j): seq2[i:i+k] == seq1[j:j+k].  Inverted dot
    (i, j): seq2[i:i+k] == revcomp(seq1[j:j+k]) — matching kmerhits'
    inverted-key emission (pyx:1403-1422) as in the dense path.
    """
    c1 = encode(seq1)
    c2 = encode(seq2)
    n1, n2 = len(c1), len(c2)
    mi, mj = n2 - k + 1, n1 - k + 1
    if mi <= 0 or mj <= 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, z, n2, n1
    rc1 = _COMP_LUT[c1][::-1]          # revcomp codes of seq1
    hap_ids, fwd_ids, rc_ids = _window_ids([c2, c1, rc1], k)
    fi, fj = _match_pairs(hap_ids, fwd_ids)
    ri, rp = _match_pairs(hap_ids, rc_ids)
    # rc window p starts at reversed position: j = n1 - k - p
    rj = (n1 - k) - rp
    keys = np.concatenate([fi * mj + fj, ri * mj + rj])
    if keys.size == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, z, n2, n1
    uniq, ww = np.unique(keys, return_counts=True)
    return uniq // mj, uniq % mj, ww.astype(np.int64), n2, n1


def dotdata(k: int, seq1: str, seq2: str) -> List[Tuple[int, int]]:
    """Expanded dot list [(i, j), ...] — multiset-equal to the reference
    ``dotdata`` (order may differ within an i; no consumer depends on it).
    """
    ii, jj, ww, _, _ = dot_arrays(k, seq1, seq2)
    out: List[Tuple[int, int]] = []
    for i, j, w in zip(ii.tolist(), jj.tolist(), ww.tolist()):
        out.extend([(i, j)] * w)
    return out


# --------------------------------------------------------------------------
# Offset clustering (value-membership semantics)
# --------------------------------------------------------------------------

def _kept_value_mask(values: np.ndarray, weights: np.ndarray,
                     gap: int, keep_threshold: int,
                     fallback_to_max: bool) -> np.ndarray:
    """Per-dot keep mask under gap clustering of offset values.

    Sort the distinct offset values; a new cluster starts whenever the
    gap to the previous distinct value is >= ``gap``.  A cluster is kept
    when its weighted dot total exceeds ``keep_threshold``; with
    ``fallback_to_max`` (dis_cluster semantics, pyx:551-564), if nothing
    clears the bar every cluster tied for the maximum total is kept.
    Membership is by value, so equal offsets co-move (pyx:564, 576).
    """
    if values.size == 0:
        return np.zeros(0, dtype=bool)
    uniq, inv = np.unique(values, return_inverse=True)
    counts = np.zeros(uniq.size, dtype=np.int64)
    np.add.at(counts, inv, weights)
    new_seg = np.ones(uniq.size, dtype=bool)
    new_seg[1:] = (uniq[1:] - uniq[:-1]) >= gap
    seg_id = np.cumsum(new_seg) - 1
    nseg = seg_id[-1] + 1
    seg_total = np.zeros(nseg, dtype=np.int64)
    np.add.at(seg_total, seg_id, counts)
    kept_seg = seg_total > keep_threshold
    if fallback_to_max and not kept_seg.any():
        kept_seg = seg_total == seg_total.max()
    return kept_seg[seg_id][inv]


def clean_mask_diag_and_anti(ii: np.ndarray, jj: np.ndarray,
                             ww: np.ndarray) -> np.ndarray:
    """clean_dotdata_diagnal_and_anti_diagnal (pyx:432-448): a dot
    survives unless removed by *both* the diagonal and anti-diagonal
    gap clusterings (threshold >10, no fallback)."""
    d = jj - ii
    a = jj + ii
    kept_d = _kept_value_mask(d, ww, 10, 10, False)
    kept_a = _kept_value_mask(a, ww, 10, 10, False)
    return kept_d | kept_a


def clean_mask_within10(ii: np.ndarray, jj: np.ndarray, ww: np.ndarray
                        ) -> np.ndarray:
    """Two-stage cleaning used by within_10Perc_m1b (pyx:281-288):
    diagonal clusters (>50 with max fallback), then anti-diagonal
    clusters over the leftovers only; kept = union."""
    if ii.size == 0:
        return np.zeros(0, dtype=bool)
    d = jj - ii
    kept_d = _kept_value_mask(d, ww, 10, 50, True)
    left = ~kept_d
    kept_a_left = np.zeros_like(kept_d)
    if left.any():
        a = (jj + ii)[left]
        kept_a_left[left] = _kept_value_mask(a, ww[left], 10, 50, True)
    return kept_d | kept_a_left


# --------------------------------------------------------------------------
# Diagonal-distance metrics (weighted, exact f64)
# --------------------------------------------------------------------------

def eu_dis_abs(ii: np.ndarray, jj: np.ndarray, ww: np.ndarray) -> float:
    """mean |i - j| over dots (pyx:705-708)."""
    total = float(np.sum(ww))
    return float(np.sum(np.abs(ii - jj) * ww)) / total


def _single_dot_dev(i0: np.ndarray, i1: np.ndarray) -> np.ndarray:
    """eu_dis_single_dot (pyx:710-716): |i0-i1| / i0, or /(i0+1) at i0==0."""
    denom = np.where(i0 == 0, i0 + 1, i0)
    return np.abs((i0 - i1) / denom)


def eu_dis_dir(i0: np.ndarray, i1: np.ndarray, ww: np.ndarray) -> float:
    """mean (i0 - i1) over dots deviating >10% (pyx:718-722)."""
    sel = _single_dot_dev(i0, i1) > 0.1
    wsel = ww * sel
    total = float(np.sum(wsel))
    if total == 0:
        return 0.0001
    return float(np.sum((i0 - i1) * wsel)) / total


def eu_dis_within_10perc(ii: np.ndarray, jj: np.ndarray, ww: np.ndarray
                         ) -> int:
    """count of dots with i>0 and |i-j|/i < 0.16 (pyx:730-733)."""
    pos = ii > 0
    dev = np.zeros(ii.shape, dtype=np.float64)
    dev[pos] = np.abs((ii[pos] - jj[pos]) / ii[pos].astype(np.float64))
    return int(np.sum(ww * (pos & (dev < 0.16))))


def _number_cluster(sorted_vals: np.ndarray, edges: Sequence[float]
                    ) -> List[np.ndarray]:
    """Bin sorted values into len(edges)-1 buckets with the reference's
    sequential scan (pyx:1104-1118): bucket b takes values < edges[b+1];
    anything past the last edge spills into the final bucket."""
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
    return [np.asarray(b) for b in bins]


def _find_longest(bins: List[np.ndarray]) -> List[np.ndarray]:
    """Bins tied for max length, deduplicated by content (pyx:788-792)."""
    lengths = [b.size for b in bins]
    top = max(lengths)
    out: List[np.ndarray] = []
    for b in bins:
        if b.size == top and not any(
                b.size == o.size and np.array_equal(b, o) for o in out):
            out.append(b)
    return out


def most_abundant_intercept(ii: np.ndarray, jj: np.ndarray,
                            ww: np.ndarray) -> float:
    """dis_to_diagnal_most_abundant_defined (pyx:582-591): two-level
    10-bin histogram mode of j - i; returns the median of the single
    winning sub-bin, or 0 on ties."""
    d = np.repeat(jj - ii, ww).astype(np.float64)
    d.sort()
    lo, hi = d[0], d[-1]
    edges = [lo + t * (hi - lo) / 10.0 for t in range(11)]
    kept1 = _find_longest(_number_cluster(d, edges))
    kept2: List[np.ndarray] = []
    for km in kept1:
        if km.size == 0:
            kept2.extend(_find_longest(_number_cluster(
                km, [0.0] * 11)))
            continue
        jlo, jhi = km.min(), km.max()
        sub_edges = [jlo + t * (jhi - jlo) / 10.0 for t in range(11)]
        kept2.extend(_find_longest(_number_cluster(np.sort(km), sub_edges)))
    if len(kept2) == 1:
        return float(np.median(kept2[0]))
    return 0.0


# --------------------------------------------------------------------------
# Scorers (pyx:161-307) — each returns [ref_metric, alt_metric]
# --------------------------------------------------------------------------

class DotSet:
    """Dots of one (read x haplotype) comparison plus gate statistics."""

    __slots__ = ("ii", "jj", "ww", "n_dots", "i_min", "i_max", "hap_len")

    def __init__(self, k: int, read: str, hap: str):
        self.ii, self.jj, self.ww, _, _ = dot_arrays(k, read, hap)
        self._finish(len(hap))

    def _finish(self, hap_len: int):
        self.n_dots = int(self.ww.sum()) if self.ww.size else 0
        self.i_min = int(self.ii.min()) if self.ii.size else 0
        self.i_max = int(self.ii.max()) if self.ii.size else 0
        self.hap_len = hap_len

    @classmethod
    def from_index(cls, index: HapKmerIndex, read: str, miss: int
                   ) -> "DotSet":
        self = cls.__new__(cls)
        self.ii, self.jj, self.ww = index.dots(read, miss)
        self._finish(max(0, index.hap_len - miss))
        return self

    @property
    def span(self) -> int:
        return self.i_max - self.i_min


def _pair(k: int, read: str, miss: int, ref_seq: str, alt_seq: str
          ) -> Tuple[DotSet, DotSet]:
    return (DotSet.from_index(_hap_index(ref_seq, k), read, miss),
            DotSet.from_index(_hap_index(alt_seq, k), read, miss))


def score_abs_dis_m1b(ref_seq: str, alt_seq: str, read: str, miss: int,
                      window: int) -> List[float]:
    """pyx:182-203 — workhorse whole-event scorer (uppercased haps)."""
    ref_seq = ref_seq.upper()
    alt_seq = alt_seq.upper()
    r, a = _pair(window, read, miss, ref_seq, alt_seq)
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
        return [eu_dis_abs(r.ii[rm], r.jj[rm], r.ww[rm]),
                eu_dis_abs(a.ii[am], a.jj[am], a.ww[am])]
    return [0, 0]


def score_within_10perc_m1b(ref_seq: str, alt_seq: str, read: str,
                            miss: int, window: int) -> List[float]:
    """pyx:277-294 — junction scorer; NOTE: returns [alt, ref] so the
    larger-is-better orientation survives the 1 - alt/ref transform."""
    r, a = _pair(window, read, miss, ref_seq, alt_seq)
    if not max(r.n_dots / len(ref_seq), a.n_dots / len(alt_seq)) > 0.1:
        return [0, 0]
    rm = clean_mask_within10(r.ii, r.jj, r.ww)
    am = clean_mask_within10(a.ii, a.jj, a.ww)
    if rm.any() and am.any():
        return [eu_dis_within_10perc(a.ii[am], a.jj[am], a.ww[am]),
                eu_dis_within_10perc(r.ii[rm], r.jj[rm], r.ww[rm])]
    return [0, 0]


def score_redefine_diagonal(ref_seq: str, alt_seq: str, read: str,
                            miss: int, window: int) -> List[float]:
    """pyx:241-257 — DUP-family scorer: re-center by the most-abundant
    intercept, then |mean directed distance| (no uppercasing)."""
    r, a = _pair(window, read, miss, ref_seq, alt_seq)
    if not (r.n_dots / len(ref_seq) > 0.1 and a.n_dots / len(alt_seq) > 0.1):
        return [0, 0]
    if not (r.span / len(ref_seq) > 0.7 and a.span / len(alt_seq) > 0.7):
        return [0, 0]
    rm = clean_mask_diag_and_anti(r.ii, r.jj, r.ww)
    am = clean_mask_diag_and_anti(a.ii, a.jj, a.ww)
    if not (rm.any() and am.any()):
        return [0, 0]
    out = []
    for ds, m in ((r, rm), (a, am)):
        c = most_abundant_intercept(ds.ii[m], ds.jj[m], ds.ww[m])
        i0 = ds.ii[m].astype(np.float64) + c
        i1 = ds.jj[m].astype(np.float64)
        out.append(abs(eu_dis_dir(i0, i1, ds.ww[m])))
    return out


# --- completeness: scorers present in the reference but unused by the CLI ---

def _clean_mask_m1(ii: np.ndarray, jj: np.ndarray, ww: np.ndarray
                   ) -> np.ndarray:
    """clean_dotdata_m1 (pyx:387-402) + anti-diagonal pass on leftovers
    (pyx:169-174): diagonal clusters (>50/max), then within each kept
    diagonal cluster an x-coordinate clustering at gap 40 (>50/max);
    leftovers get one anti-diagonal pass (>50/max)."""
    if ii.size == 0:
        return np.zeros(0, dtype=bool)
    d = jj - ii
    kept_d = _kept_value_mask(d, ww, 10, 50, True)
    kept = np.zeros_like(kept_d)
    # secondary x-clustering runs per maximal d-cluster
    uniq = np.unique(d[kept_d])
    if uniq.size:
        breaks = np.nonzero(np.diff(uniq) >= 10)[0]
        starts = np.concatenate([[0], breaks + 1])
        ends = np.concatenate([breaks, [uniq.size - 1]])
        for s, e in zip(starts, ends):
            sel = kept_d & (d >= uniq[s]) & (d <= uniq[e])
            sub = _kept_value_mask(ii[sel], ww[sel], 40, 50, True)
            idx = np.nonzero(sel)[0]
            kept[idx[sub]] = True
    left = ~kept
    if left.any():
        a = (jj + ii)[left]
        sub = _kept_value_mask(a, ww[left], 10, 50, True)
        idx = np.nonzero(left)[0]
        kept[idx[sub]] = True
    return kept


def score_abs_dis_m1(ref_seq: str, alt_seq: str, read: str, miss: int,
                     window: int) -> List[float]:
    """pyx:161-180 (legacy two-stage cleaner variant)."""
    ref_seq = ref_seq.upper()
    alt_seq = alt_seq.upper()
    r, a = _pair(window, read, miss, ref_seq, alt_seq)
    if not (r.n_dots / len(ref_seq) > 0.1 and a.n_dots / len(alt_seq) > 0.1):
        return [0, 0]
    if not (r.span / len(ref_seq) > 0.7 and a.span / len(alt_seq) > 0.7):
        return [0, 0]
    rm = _clean_mask_m1(r.ii, r.jj, r.ww)
    am = _clean_mask_m1(a.ii, a.jj, a.ww)
    if rm.any() and am.any():
        return [eu_dis_abs(r.ii[rm], r.jj[rm], r.ww[rm]),
                eu_dis_abs(a.ii[am], a.jj[am], a.ww[am])]
    return [0, 0]


def score_abs_dis_m2(ref_seq: str, alt_seq: str, read: str, miss: int,
                     window: int) -> List[float]:
    """pyx:296-307 — keeps per-column nearest-to-diagonal dots."""
    r, a = _pair(window, read, miss, ref_seq, alt_seq)
    if not (r.n_dots / len(ref_seq) > 0.1 and a.n_dots / len(alt_seq) > 0.1
            and r.span / len(ref_seq) > 0.7 and a.span / len(alt_seq) > 0.7):
        return [0, 0]
    out = []
    for ds in (r, a):
        ii, jj = _nearest_to_diagonal(ds.ii, ds.jj)
        if ii.size == 0:
            return [0, 0]
        out.append(eu_dis_abs(ii, jj, np.ones_like(ii)))
    return out


def _nearest_to_diagonal(ii: np.ndarray, jj: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """clean_dotdata_m2 (pyx:461-469): per distinct i, the first-seen j
    minimizing |j - i| (first occurrence wins ties)."""
    best = {}
    for i, j in zip(ii.tolist(), jj.tolist()):
        if i not in best or abs(j - i) < abs(best[i] - i):
            best[i] = j
    keys = np.asarray(sorted(best), dtype=np.int64)
    return keys, np.asarray([best[i] for i in keys.tolist()], dtype=np.int64)


def _expand_pairs(ii, jj, ww):
    out = []
    for i, j, w in zip(ii.tolist(), jj.tolist(), ww.tolist()):
        out.extend([[int(i), int(j)]] * int(w))
    return out


def score_directed_m1b(ref_seq: str, alt_seq: str, read: str, miss: int,
                       window: int) -> List[float]:
    """pyx:205-225 — KDE ratio-regressed directed distance (unused by
    the CLI; host-only because of the gaussian-KDE mode fit)."""
    from .legacy import eu_dis_reg_calcu
    r, a = _pair(window, read, miss, ref_seq, alt_seq)
    if not (r.n_dots / len(ref_seq) > 0.1 and a.n_dots / len(alt_seq) > 0.1):
        return [0, 0]
    if not (r.span / len(ref_seq) > 0.7 and a.span / len(alt_seq) > 0.7):
        return [0, 0]
    rm = clean_mask_diag_and_anti(r.ii, r.jj, r.ww)
    am = clean_mask_diag_and_anti(a.ii, a.jj, a.ww)
    if rm.any() and am.any():
        return [eu_dis_reg_calcu(_expand_pairs(r.ii[rm], r.jj[rm],
                                               r.ww[rm])),
                eu_dis_reg_calcu(_expand_pairs(a.ii[am], a.jj[am],
                                               a.ww[am]))]
    return [0, 0]


SCORERS = {
    "abs_dis_m1b": score_abs_dis_m1b,
    "within_10perc_m1b": score_within_10perc_m1b,
    "redefine_diagonal": score_redefine_diagonal,
    "abs_dis_m1": score_abs_dis_m1,
    "abs_dis_m2": score_abs_dis_m2,
    "directed_m1b": score_directed_m1b,
}
