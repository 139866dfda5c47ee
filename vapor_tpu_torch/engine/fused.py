"""Fused scoring engine: one device pass per (scorer, haplotype, read group).

Per (read, haplotype) row the engine needs a few exact integers: hit
counts, the first and last hap row with a hit, and moment sums over the
hits that survive the reference's 1-D gap-cluster cleaning.  The work
splits into six dot-plot kernels and three glue kernels (engine/kernels),
all on the caller's device:

1. ``row_codes``: each k-mer becomes ceil(k/8) int32 words of 4-bit
   symbols; the reverse strand's codes are laid out by dot-space column,
   so both strands compare against the same cells;
2. ``hist``: diagonal (j - i + H) and anti-diagonal (j + i) histograms of
   the hit multiplicity, plus the gate scalars;
3. ``kept_tables``: gap clustering of histograms into keep tables;
4. ``left_hist`` (w10, del): the anti-diagonal histogram of the hits the
   diagonal table drops, for the within-10% second stage;
   ``kept_hist`` (rdd): the diagonal histogram of the kept hits, from
   which ``intercept_z`` fits each row's intercept on the device;
5. ``moment`` (m1b, w10) / ``moment2`` (del) / ``rdd_moment`` (rdd):
   moment sums over the cells whose bins are kept (rdd adds the
   selection sums around the intercept).

Between them run a few torch ops only: rdd's shift of the intercept, the
widening of hist's scalars and the concatenation of the packed rows.
Only those rows go to the host, which finishes the float math in f64
exactly like the oracle.
"""
from __future__ import annotations

import functools
from typing import List, Sequence

import numpy as np
import torch

from ..parallel.mesh import maybe_mesh_rows
from ..utils import trace
from . import kernels, oracle
# backends check sequences against the engine alphabet VOCAB_OK and score
# through the oracle otherwise
from .constants import HAP_PAD, READ_PAD, VOCAB_OK, bucket_for

MODES = ("m1b", "w10", "del", "rdd")


# ---------------------------------------------------------------------------
# the glue between the six kernels, each a kernel of its own on the card
# ---------------------------------------------------------------------------

def row_codes(haps, reads, rlens, k: int, hap_index=None):
    """(U, H) hap and (B, R) forward read codes -> the kernels' code
    arrays (ch, cf, cd): hap (one row per read with hap_index), forward
    and dot-space reverse-strand (kernels.row_codes: the codes kernel on
    the card, pack_codes / derive_rc_rows / rc_dot_codes on the CPU)."""
    return kernels.row_codes(haps, reads, rlens, k, hap_index)


def kept_table(h: torch.Tensor, gap: int, thr: int, fallback_max: bool,
               H: int, R: int) -> torch.Tensor:
    """(B, W) histograms of an (H, R) batch -> (B, W) bool keep tables
    (pyx:551-580 semantics): clusters of present values (a gap < `gap`
    merges) are kept when their weighted total exceeds thr, else, with
    the fallback, when the total equals the maximum.  One table of
    kernels.kept_tables."""
    return kernels.kept_tables((h,), ((thr, fallback_max),), H, R, gap)[0]


def intercept_z(h: torch.Tensor, H: int, R: int):
    """(B, W) d-histograms of an (H, R) batch over bins j - i + H ->
    (found (B,) bool, z (B,) int64), z twice the re-centering intercept
    of each row (pyx:582-591, exact integers; kernels.intercept_z)."""
    return kernels.intercept_z(h, H, R)


# ---------------------------------------------------------------------------
# per-row statistics
# ---------------------------------------------------------------------------

def fused_rows(haps, reads, rlens, ms, k: int, scorer: str,
               hap_index=None):
    """Statistics of each (read, hap) row; the counterpart of the JAX
    engine's per-row ``_fused_one`` for modes m1b, w10, del and rdd.
    With hap_index (B,) int64, haps holds U unique rows and row b's hap
    is haps[hap_index[b]]: each is packed once and the codes expanded.

    -> h_d, h_a (B, W) int32 histograms and packed int64 rows
    [n_f, n_r, i_min, i_max, cnt, sum_absd, w10] (7 columns), followed
    for del by [cnt2, sum_absd2, w10_2] (the within-10% set) and for rdd
    by [sel_cnt, sel_pos, sel_neg] (w10 is 0 there); FusedStats decodes
    them by mode."""
    if scorer not in MODES:
        raise ValueError(f"unknown device mode {scorer!r}; want one of "
                         f"{MODES}")
    H, R = haps.shape[1], reads.shape[1]
    codes = (*kernels.row_codes(haps, reads, rlens, k, hap_index), ms,
             rlens, k)
    h_d, h_a, scal = kernels.hist(*codes)
    # the keep tables: 10-threshold (kd, ka), 50-threshold with the max
    # fallback (kd50, then ka50 over left_hist's histogram); one launch
    # for those whose histograms are ready
    m1b_tables = ((h_d, h_a), ((10, False), (10, False)))
    if scorer in ("m1b", "rdd"):
        kd, ka = kernels.kept_tables(*m1b_tables, H, R)
    elif scorer == "del":
        kd, ka, kd50 = kernels.kept_tables(
            (*m1b_tables[0], h_d), (*m1b_tables[1], (50, True)), H, R)
    else:
        kd50, = kernels.kept_tables((h_d,), ((50, True),), H, R)
    if scorer in ("w10", "del"):
        ka50, = kernels.kept_tables((kernels.left_hist(*codes, kd50),),
                                    ((50, True),), H, R)
    if scorer == "m1b":
        mom = kernels.moment(*codes, kd, ka, want_w10=False)
    elif scorer == "w10":
        mom = kernels.moment(*codes, kd50, ka50, want_w10=True)
    elif scorer == "del":
        mom = kernels.moment2(*codes, kd, ka, kd50, ka50)
    else:
        # the histogram holds j - i = d - m: shift the median back only
        # when an intercept was found (no intercept means z = 0)
        found, z = kernels.intercept_z(kernels.kept_hist(*codes, kd, ka),
                                       H, R)
        z = torch.where(found, z + 2 * ms, 0).to(torch.int32)
        mom = kernels.rdd_moment(*codes, kd, ka, z)
    return h_d, h_a, torch.cat([kernels.hist_scal(scal, H), mom], 1)


def batch_from_numpy(haps: np.ndarray, reads: np.ndarray,
                     rlens: np.ndarray, ms: np.ndarray, k_idx: int,
                     device) -> tuple:
    """The JAX engine's numpy batch -> fused_batch's leading arguments on
    `device`: (haps (B, H) uint8, reads (B, R) uint8 forward codes with a
    READ_PAD tail, rlens (B,) int32, ms (B,) int32, k_idx in 0..3)."""
    def put(a, dtype):     # a C-order copy: `a` may be a read-only
        # broadcast, and the kernels take contiguous rows
        return torch.from_numpy(np.array(a, dtype=dtype,
                                         order="C")).to(device)
    return (put(haps, np.uint8), put(reads, np.uint8),
            put(rlens, np.int32), put(ms, np.int32), int(k_idx))


def fused_batch(haps, reads, rlens, ms, k_idx: int, H: int, R: int,
                scorer: str, hap_index=None):
    """Batched per-(read, hap) statistics: the production scoring entry.

    With hap_index (B,) int64, haps holds (U, H) unique rows and row b
    scores haps[hap_index[b]] (the batching backend's deduplicated
    upload; the per-row result does not change).  When several cards
    are visible the rows split over them (parallel.mesh.maybe_mesh_rows,
    the histograms are then not returned: no scoring path reads them);
    on one device this is fused_batch_local.  Per-row math is
    integer-exact, so the packed rows are bit-identical either way.
    -> (h_d, h_a, packed)."""
    if tuple(haps.shape[1:]) != (H,) or tuple(reads.shape[1:]) != (R,):
        raise ValueError(f"want (B, {H}) haps and (B, {R}) reads, got "
                         f"{tuple(haps.shape)} and {tuple(reads.shape)}")
    packed = maybe_mesh_rows(haps, reads, rlens, ms, k_idx, H, R, scorer,
                             hap_index=hap_index)
    if packed is not None:
        return None, None, packed
    return fused_batch_local(haps, reads, rlens, ms, k_idx, scorer,
                             hap_index)


def fused_batch_local(haps, reads, rlens, ms, k_idx: int, scorer: str,
                      hap_index=None):
    """fused_batch on the rows' own device, in one launch per kernel.

    Rows go through in groups of min(8, B), the JAX engine's row
    grouping: pad rows carry HAP_PAD / READ_PAD codes, rlen = 1 and m = 0,
    so they hold no eligible cell (the kernels skip them outright), and
    are cut off again before returning.  -> (h_d, h_a, packed)."""
    B = reads.shape[0]
    pad = (-B) % min(8, B)
    if pad:
        def grow(x, value, n=pad):
            return torch.cat([x, torch.full((n,) + x.shape[1:], value,
                                            dtype=x.dtype,
                                            device=x.device)])
        if hap_index is not None:     # pad rows -> one all-HAP_PAD row
            hap_index = grow(hap_index, haps.shape[0])
            haps = grow(haps, HAP_PAD, 1)
        else:
            haps = grow(haps, HAP_PAD)
        reads, rlens, ms = grow(reads, READ_PAD), grow(rlens, 1), \
            grow(ms, 0)
    h_d, h_a, packed = fused_rows(haps, reads, rlens, ms,
                                  10 * (int(k_idx) + 1), scorer, hap_index)
    return h_d[:B], h_a[:B], packed[:B]


# ---------------------------------------------------------------------------
# host-facing backend
# ---------------------------------------------------------------------------

class FusedStats:
    """Exact-integer host view of one fused batch of device mode `mode`
    (the packed rows cross to the host in one copy, or arrive there as
    an int64 array from the batching backend; the histograms stay on
    the device)."""

    def __init__(self, h_d, h_a, packed, mode: str):
        if mode not in MODES:
            raise ValueError(f"unknown device mode {mode!r}")
        self.h_d, self.h_a = h_d, h_a
        p = packed if isinstance(packed, np.ndarray) else \
            packed.cpu().numpy()
        self.n_dots = p[:, 0] + p[:, 1]
        self.i_min = p[:, 2]
        self.i_max = p[:, 3]
        self.cnt = p[:, 4]
        self.sum_absd = p[:, 5]
        self.w10 = p[:, 6]
        if mode == "del":      # the within-10% set
            self.cnt2, self.sum_absd2, self.w10_2 = p[:, 7:10].T
        elif mode == "rdd":    # the selection block around the intercept
            self.sel_cnt, self.sel_pos, self.sel_neg = p[:, 7:10].T

    def span(self, b: int) -> int:
        if self.n_dots[b] == 0:
            return 0
        return int(self.i_max[b] - self.i_min[b])


class _Ready:
    """Already-resolved future (torch launches are asynchronous already;
    reading the packed rows waits for them)."""

    __slots__ = ("_v",)

    def __init__(self, v):
        self._v = v

    def result(self):
        return self._v


class FusedBackend:
    """Device backend: one fused pass per (scorer, haplotype, read
    group) on `device`."""

    name = "torch-nobatch"

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("the torch backend was asked for CUDA, but "
                               "torch.cuda.is_available() is False")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")

    def _encode_hap(self, seq: str, H: int) -> np.ndarray:
        codes = oracle.encode(seq)
        out = np.full(H, HAP_PAD, dtype=np.uint8)
        out[: len(codes)] = codes
        return out

    def _encode_reads(self, reads: Sequence[Sequence], R: int):
        """Forward-strand codes; the device derives the reverse strand."""
        B = len(reads)
        fw = np.full((B, R), READ_PAD, dtype=np.uint8)
        rlens = np.zeros(B, dtype=np.int32)
        ms = np.zeros(B, dtype=np.int32)
        for b, r in enumerate(reads):
            codes = oracle.encode(r[0])
            fw[b, : len(codes)] = codes
            rlens[b] = len(codes)
            ms[b] = int(r[1])
        return fw, rlens, ms

    def _submit(self, hap_codes, enc, window, H, R, scorer):
        """Launches one (hap, reads) request; returns a future-like
        handle whose result is (h_d, h_a, packed)."""
        fw, rlens, ms = enc
        # the one hap row, which every read row indexes
        return _Ready(fused_batch(
            *batch_from_numpy(hap_codes[None], fw, rlens, ms,
                              window // 10 - 1, self.device),
            H=H, R=R, scorer=scorer,
            hap_index=torch.zeros(fw.shape[0], dtype=torch.int64,
                                  device=self.device)))

    @trace.spanned("dispatch")
    def score_del_batch_async(self, ref_seq: str, alt_seq: str,
                              reads: Sequence[Sequence], window: int):
        """Combined DEL scoring; returns a finisher producing
        (m1b_scores, w10_scores) - one device pass per haplotype instead
        of two."""
        if not reads:
            return lambda: ([], [])
        ref_m1b = ref_seq.upper()
        alt_m1b = alt_seq.upper()
        try:
            H_r = bucket_for(len(ref_m1b) + 1)
            H_a = bucket_for(len(alt_m1b) + 1)
            r_groups = self._read_groups(reads)
        except ValueError:
            out = ([oracle.SCORERS["abs_dis_m1b"](
                        ref_seq, alt_seq, r[0], r[1], window)
                    for r in reads],
                   [oracle.SCORERS["within_10perc_m1b"](
                        ref_seq, alt_seq, r[0], r[1], window)
                    for r in reads])
            return lambda: out
        haps = [self._encode_hap(s, hh) for s, hh in
                ((ref_m1b, H_r), (alt_m1b, H_a), (ref_seq, H_r),
                 (alt_seq, H_a))]
        encs = [(idxs, self._encode_reads([reads[i] for i in idxs], R))
                for R, idxs in r_groups]
        if not (all(VOCAB_OK[h].all() for h in haps)
                and all(VOCAB_OK[enc[0]].all()
                        for _, enc in encs)):
            out = ([oracle.SCORERS["abs_dis_m1b"](
                        ref_seq, alt_seq, r[0], r[1], window)
                    for r in reads],
                   [oracle.SCORERS["within_10perc_m1b"](
                        ref_seq, alt_seq, r[0], r[1], window)
                    for r in reads])
            return lambda: out
        # m1b runs on uppercased haps, within-10% on the raw ones
        # (pyx:183-184 vs 278) - same device mode, different codes
        raw_differs = ref_seq != ref_m1b or alt_seq != alt_m1b
        pend = []
        for (R, idxs), (_, enc) in zip(r_groups, encs):
            d_ref_u = self._submit(haps[0], enc, window, H_r, R, "del")
            d_alt_u = self._submit(haps[1], enc, window, H_a, R, "del")
            if raw_differs:
                d_ref_r = self._submit(haps[2], enc, window, H_r, R,
                                       "del")
                d_alt_r = self._submit(haps[3], enc, window, H_a, R,
                                       "del")
            else:
                d_ref_r, d_alt_r = d_ref_u, d_alt_u
            pend.append((idxs, d_ref_u, d_alt_u, d_ref_r, d_alt_r))
        return functools.partial(
            self._finish_del, ref_seq, alt_seq, ref_m1b, alt_m1b,
            len(reads), pend)

    def score_del_batch(self, ref_seq: str, alt_seq: str,
                        reads: Sequence[Sequence], window: int):
        return self.score_del_batch_async(ref_seq, alt_seq, reads,
                                          window)()

    def _finish_del(self, ref_seq, alt_seq, ref_m1b, alt_m1b, n_reads,
                    pend):
        m1b = [None] * n_reads
        w10 = [None] * n_reads
        for idxs, d_ref_u, d_alt_u, d_ref_r, d_alt_r in pend:
            su_ref = FusedStats(*d_ref_u.result(), "del")
            su_alt = FusedStats(*d_alt_u.result(), "del")
            sr_ref = FusedStats(*d_ref_r.result(), "del")
            sr_alt = FusedStats(*d_alt_r.result(), "del")
            for b, i in enumerate(idxs):
                nr, na = int(su_ref.n_dots[b]), int(su_alt.n_dots[b])
                if not (nr > 2 and na > 2) or not \
                        float(nr) / min(float(len(ref_m1b)),
                                        float(len(alt_m1b))) > 0.1:
                    m1b[i] = [0, 0]
                else:
                    r_ok = float(su_ref.span(b)) / \
                        float(len(ref_m1b)) > 0.6
                    a_ok = float(su_alt.span(b)) / \
                        float(len(alt_m1b)) > 0.6
                    if not (r_ok and a_ok):
                        m1b[i] = [1.1, 2.1] if r_ok else \
                            ([2.1, 1.1] if a_ok else [0, 0])
                    else:
                        cr = int(su_ref.cnt[b])
                        ca = int(su_alt.cnt[b])
                        if cr > 0 and ca > 0:
                            m1b[i] = [float(su_ref.sum_absd[b]) / cr,
                                      float(su_alt.sum_absd[b]) / ca]
                        else:
                            m1b[i] = [0, 0]
                nr2, na2 = int(sr_ref.n_dots[b]), int(sr_alt.n_dots[b])
                if not max(float(nr2) / float(len(ref_seq)),
                           float(na2) / float(len(alt_seq))) > 0.1:
                    w10[i] = [0, 0]
                elif int(sr_ref.cnt2[b]) > 0 and \
                        int(sr_alt.cnt2[b]) > 0:
                    w10[i] = [int(sr_alt.w10_2[b]),
                              int(sr_ref.w10_2[b])]
                else:
                    w10[i] = [0, 0]
        return m1b, w10

    @staticmethod
    def _read_groups(reads):
        """Original-index groups by per-read R bucket: reads pad only to
        their own length bucket, since per-row cell count is the
        engine's cost.  Padding never changes a score."""
        groups = {}
        for i, r in enumerate(reads):
            groups.setdefault(bucket_for(len(r[0]) + 1), []).append(i)
        return sorted(groups.items())

    @trace.spanned("dispatch")
    def score_batch_async(self, scorer: str, ref_seq: str,
                          alt_seq: str, reads: Sequence[Sequence],
                          window: int):
        """Dispatches scoring without blocking; returns a zero-arg
        finisher.  Only abs_dis_m1b scores upper-cased haps; the
        within-10% and redefine-diagonal scorers see them as given."""
        if not reads:
            return lambda: []
        if scorer in ("abs_dis_m1", "abs_dis_m2"):
            out = [oracle.SCORERS[scorer](ref_seq, alt_seq, r[0], r[1],
                                          window) for r in reads]
            return lambda: out
        upper = scorer == "abs_dis_m1b"
        ref_s = ref_seq.upper() if upper else ref_seq
        alt_s = alt_seq.upper() if upper else alt_seq
        try:
            # each hap pads only to its own bucket: padding never
            # changes scores
            H_r = bucket_for(len(ref_s) + 1)
            H_a = bucket_for(len(alt_s) + 1)
            r_groups = self._read_groups(reads)
        except ValueError:
            out = [oracle.SCORERS[scorer](ref_seq, alt_seq, r[0], r[1],
                                          window) for r in reads]
            return lambda: out
        mode = {"abs_dis_m1b": "m1b", "within_10perc_m1b": "w10",
                "redefine_diagonal": "rdd"}[scorer]
        hr = self._encode_hap(ref_s, H_r)
        ha = self._encode_hap(alt_s, H_a)
        encs = [(idxs, self._encode_reads([reads[i] for i in idxs], R))
                for R, idxs in r_groups]
        if not (VOCAB_OK[hr].all() and VOCAB_OK[ha].all()
                and all(VOCAB_OK[enc[0]].all()
                        for _, enc in encs)):
            out = [oracle.SCORERS[scorer](ref_seq, alt_seq, r[0], r[1],
                                          window) for r in reads]
            return lambda: out
        # launch every group's two haplotypes before reading any back
        pend = [(idxs,
                 self._submit(hr, enc, window, H_r, R, mode),
                 self._submit(ha, enc, window, H_a, R, mode))
                for (R, idxs), (_, enc) in zip(r_groups, encs)]
        return functools.partial(self._finish_score, mode, ref_s,
                                 alt_s, len(reads), pend)

    def score_batch(self, scorer: str, ref_seq: str, alt_seq: str,
                    reads: Sequence[Sequence], window: int
                    ) -> List[List[float]]:
        return self.score_batch_async(scorer, ref_seq, alt_seq, reads,
                                      window)()

    def _finish_score(self, mode, ref_s, alt_s, n_reads, pend
                      ) -> List[List[float]]:
        out: List[List[float]] = [None] * n_reads
        for idxs, d_ref, d_alt in pend:
            s_ref = FusedStats(*d_ref.result(), mode)
            s_alt = FusedStats(*d_alt.result(), mode)
            for b, i in enumerate(idxs):
                out[i] = self._score_pair(mode, ref_s, alt_s, s_ref,
                                          s_alt, b)
        return out

    @staticmethod
    def _score_pair(mode, ref_s, alt_s, s_ref, s_alt, b):
        nr, na = int(s_ref.n_dots[b]), int(s_alt.n_dots[b])
        if mode == "m1b":
            if not (nr > 2 and na > 2):
                return [0, 0]
            if not float(nr) / min(float(len(ref_s)),
                                   float(len(alt_s))) > 0.1:
                return [0, 0]
            r_ok = float(s_ref.span(b)) / float(len(ref_s)) > 0.6
            a_ok = float(s_alt.span(b)) / float(len(alt_s)) > 0.6
            if not (r_ok and a_ok):
                return [1.1, 2.1] if r_ok else \
                    ([2.1, 1.1] if a_ok else [0, 0])
            cr, ca = int(s_ref.cnt[b]), int(s_alt.cnt[b])
            if cr > 0 and ca > 0:
                return [float(s_ref.sum_absd[b]) / cr,
                        float(s_alt.sum_absd[b]) / ca]
            return [0, 0]
        if mode == "w10":
            if not max(float(nr) / float(len(ref_s)),
                       float(na) / float(len(alt_s))) > 0.1:
                return [0, 0]
            if int(s_ref.cnt[b]) > 0 and int(s_alt.cnt[b]) > 0:
                return [int(s_alt.w10[b]), int(s_ref.w10[b])]
            return [0, 0]
        # rdd
        if not (float(nr) / float(len(ref_s)) > 0.1 and
                float(na) / float(len(alt_s)) > 0.1):
            return [0, 0]
        if not (float(s_ref.span(b)) / float(len(ref_s)) > 0.7
                and float(s_alt.span(b)) / float(len(alt_s)) > 0.7):
            return [0, 0]
        if int(s_ref.cnt[b]) == 0 or int(s_alt.cnt[b]) == 0:
            return [0, 0]
        pair = []
        for s in (s_ref, s_alt):
            n_sel = int(s.sel_cnt[b])
            if n_sel == 0:
                pair.append(0.0001)
            else:
                total = float(int(s.sel_pos[b]) - int(s.sel_neg[b]))
                pair.append(abs((total / 2.0) / n_sel))
        return pair
