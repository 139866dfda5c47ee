"""Fused scoring engine: one device pass per (scorer, haplotype, read group).

Per (read, haplotype) row the engine needs a few exact integers: hit
counts, the first and last hap row with a hit, and moment sums over the
hits that survive the reference's 1-D gap-cluster cleaning.  The work
splits into four kernels (engine/kernels) with small torch steps between
them, all on the caller's device:

1. ``pack_codes`` / ``rc_dot_codes``: each k-mer becomes ceil(k/8) int32
   words of 4-bit symbols; the reverse strand's codes are laid out by
   dot-space column, so both strands compare against the same cells;
2. ``hist``: diagonal (j - i + H) and anti-diagonal (j + i) histograms of
   the hit multiplicity, plus the gate scalars;
3. ``kept_table``: gap clustering of a histogram into a keep table;
4. ``left_hist`` (w10, del): the anti-diagonal histogram of the hits the
   diagonal table drops, for the within-10% second stage;
5. ``moment`` (m1b, w10) / ``moment2`` (del): moment sums over the cells
   whose bins are kept.

Only the packed per-row integers go to the host, which finishes the
float math in f64 exactly like the oracle.
"""
from __future__ import annotations

import functools
from typing import List, Sequence

import numpy as np
import torch

from . import kernels, oracle
from .constants import HAP_PAD, READ_PAD, bucket_for

# The engine alphabet: every code the CLI paths can produce (key_modify
# collapses IUPAC to N/n), the INS 'X' placeholder and '=', and the three
# never-matching sentinels.  Backends check sequences against _VOCAB_OK
# and score through the oracle otherwise.
_VOCAB = np.frombuffer(b"ACGTNacgtn", dtype=np.uint8)
_VOCAB_OK = np.zeros(256, dtype=bool)
_VOCAB_OK[_VOCAB] = True
for _c in b"Xx=":
    _VOCAB_OK[_c] = True
_VOCAB_OK[HAP_PAD] = _VOCAB_OK[READ_PAD] = _VOCAB_OK[0xFE] = True

# 4-bit symbol of each admitted byte.  Injective on the 16 bytes of
# _VOCAB_OK; windows running past a sequence end pick up side-specific
# pad symbols, so cross-side matches there are impossible.
_NIB_BYTES = bytes(_VOCAB) + b"Xx=" + bytes([HAP_PAD, READ_PAD, 0xFE])
_NIB_LUT = np.full(256, 15, dtype=np.int64)
for _i, _c in enumerate(_NIB_BYTES):
    _NIB_LUT[_c] = _i

MODES = ("m1b", "w10", "del")


# ---------------------------------------------------------------------------
# codes
# ---------------------------------------------------------------------------

def pack_codes(seqs: torch.Tensor, k: int, pad_byte: int) -> torch.Tensor:
    """(B, L) uint8 -> (B, lanes, L) int32 rolling packed k-mer codes.

    Lane l packs window symbols [8l, min(8l + 8, k)), 4 bits each;
    positions whose window runs past the end pack the pad's symbol."""
    B, L = seqs.shape
    lanes = -(-k // 8)
    lut = torch.as_tensor(_NIB_LUT, device=seqs.device)
    ext = torch.cat([lut[seqs.long()],
                     torch.full((B, 8 * lanes), int(_NIB_LUT[pad_byte]),
                                dtype=torch.int64, device=seqs.device)], 1)
    out = []
    for lane in range(lanes):
        acc = torch.zeros((B, L), dtype=torch.int64, device=seqs.device)
        for t in range(min(8, k - 8 * lane)):
            s = 8 * lane + t
            acc |= ext[:, s:s + L] << (4 * t)
        # the 32 bits as a signed int32 (only equality is ever asked)
        out.append(torch.where(acc >= 2 ** 31, acc - 2 ** 32, acc))
    return torch.stack(out, 1).to(torch.int32)


def derive_rc_rows(reads: torch.Tensor, rlens: torch.Tensor
                   ) -> torch.Tensor:
    """(B, R) forward codes -> (B, R) reverse-complement codes followed by
    a READ_PAD tail: the host's encode_comp(seq)[::-1] + pad, byte for
    byte (oracle.encode_comp is a code-level LUT)."""
    B, R = reads.shape
    comp = torch.as_tensor(oracle._COMP_LUT, device=reads.device)[
        reads.long()]
    ext = torch.cat([comp.flip(1), torch.full_like(comp, READ_PAD)], 1)
    idx = (R - rlens.long())[:, None] + torch.arange(R, device=reads.device)
    return ext.gather(1, idx)


def rc_dot_codes(rc: torch.Tensor, rlens: torch.Tensor, k: int
                 ) -> torch.Tensor:
    """(B, R) rc rows -> (B, lanes, R) codes D with D[:, :, j] the packed
    rc k-mer at q = rlen - k - j, i.e. indexed by the dot-space column j.

    With rev[p] = crc[R-1-p], crc[rlen-k-j] = rev[(R-1+k-rlen) + j].
    Holds for rc rows laid out as codes then a READ_PAD tail (what
    derive_rc_rows makes); columns j > rlen - k carry garbage and are
    outside every kernel's eligible cells."""
    B, R = rc.shape
    rev = pack_codes(rc, k, READ_PAD).flip(2)
    ext = torch.cat([rev, rev], 2)
    off = ((R - 1 + k) - rlens.long()).clamp(0, R)
    idx = off[:, None] + torch.arange(R, device=rc.device)
    return ext.gather(2, idx[:, None, :].expand(-1, ext.shape[1], -1))


# ---------------------------------------------------------------------------
# gap clustering (exact, pyx:551-580 semantics)
# ---------------------------------------------------------------------------

def _cummin(x: torch.Tensor) -> torch.Tensor:
    return -torch.cummax(-x, 1).values


def kept_table(h: torch.Tensor, gap: int, thr: int,
               fallback_max: bool) -> torch.Tensor:
    """(B, W) histograms -> (B, W) bool keep tables: clusters of present
    values (a gap < `gap` merges) are kept when their weighted total
    exceeds thr, else, with the fallback, when the total equals the
    maximum."""
    B, W = h.shape
    h = h.long()
    idx = torch.arange(W, device=h.device).expand(B, W)
    nz = h > 0
    prev_nz = torch.cummax(torch.where(nz, idx, -1), 1).values
    prev_excl = torch.cat([torch.full_like(prev_nz[:, :1], -1),
                           prev_nz[:, :-1]], 1)
    is_start = nz & ((idx - prev_excl >= gap) | (prev_excl < 0))
    cum = torch.cumsum(h, 1)
    cum_excl = torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], 1)
    cum_before = torch.cummax(torch.where(is_start, cum_excl, -1), 1).values
    running = cum - cum_before
    # a segment ends one before the next start, or at the last bin
    nxt = _cummin(torch.where(is_start, idx, W + 1).flip(1)).flip(1)
    nxt_excl = torch.cat([nxt[:, 1:], torch.full_like(nxt[:, :1], W + 1)],
                         1)
    seg_end = (nxt_excl - 1).clamp(max=W - 1)
    seg_total = running.gather(1, seg_end)
    over = nz & (seg_total > thr)
    if not fallback_max:
        return over
    # segment representatives are the start bins (an end bin can be a
    # trailing zero when the segment runs to the boundary)
    max_total = torch.where(is_start, seg_total, 0).amax(1, keepdim=True)
    fallback = nz & (seg_total == max_total)
    return torch.where(over.any(1, keepdim=True), over, fallback)


# ---------------------------------------------------------------------------
# per-row statistics
# ---------------------------------------------------------------------------

def row_codes(haps, reads, rlens, k: int):
    """(B, H) hap and (B, R) forward read codes -> the kernels' code
    arrays (ch, cf, cd): hap, forward and dot-space reverse-strand."""
    return (pack_codes(haps, k, HAP_PAD), pack_codes(reads, k, READ_PAD),
            rc_dot_codes(derive_rc_rows(reads, rlens), rlens, k))


def fused_rows(haps, reads, rlens, ms, k: int, scorer: str):
    """Statistics of each (read, hap) row; the counterpart of the JAX
    engine's per-row ``_fused_one`` for modes m1b, w10 and del.

    -> h_d, h_a (B, W) int32 histograms and packed (B, 7 or 10) int64
    rows [n_f, n_r, i_min, i_max, cnt, sum_absd, w10] (+ [cnt2,
    sum_absd2, w10_2] for del, the within-10% set)."""
    if scorer not in MODES:
        raise NotImplementedError(
            f"device mode {scorer!r} is not ported yet: the rdd kernels "
            "(kept_hist, rdd_moment) come in the next slice")
    codes = (*row_codes(haps, reads, rlens, k), ms, rlens, k)
    h_d, h_a, scal = kernels.hist(*codes)
    if scorer in ("m1b", "del"):
        kd = kept_table(h_d, 10, 10, False)
        ka = kept_table(h_a, 10, 10, False)
    if scorer in ("w10", "del"):
        kd50 = kept_table(h_d, 10, 50, True)
        ka50 = kept_table(kernels.left_hist(*codes, kd50), 10, 50, True)
    if scorer == "m1b":
        mom = kernels.moment(*codes, kd, ka, want_w10=False)
    elif scorer == "w10":
        mom = kernels.moment(*codes, kd50, ka50, want_w10=True)
    else:
        mom = kernels.moment2(*codes, kd, ka, kd50, ka50)
    return h_d, h_a, torch.cat([scal.long(), mom], 1)


def batch_from_numpy(haps: np.ndarray, reads: np.ndarray,
                     rlens: np.ndarray, ms: np.ndarray, k_idx: int,
                     device) -> tuple:
    """The JAX engine's numpy batch -> fused_batch's leading arguments on
    `device`: (haps (B, H) uint8, reads (B, R) uint8 forward codes with a
    READ_PAD tail, rlens (B,) int32, ms (B,) int32, k_idx in 0..3)."""
    def put(a, dtype):     # a copy: `a` may be a read-only broadcast
        return torch.from_numpy(np.array(a, dtype=dtype)).to(device)
    return (put(haps, np.uint8), put(reads, np.uint8),
            put(rlens, np.int32), put(ms, np.int32), int(k_idx))


def fused_batch(haps, reads, rlens, ms, k_idx: int, H: int, R: int,
                scorer: str):
    """Batched per-(read, hap) statistics: the production scoring entry.

    Rows go through in groups of min(8, B), the JAX engine's row
    grouping: pad rows carry HAP_PAD / READ_PAD codes, rlen = 1 and m = 0,
    so they hold no eligible cell (the kernels skip them outright), and
    are cut off again before returning.  -> (h_d, h_a, packed)."""
    if tuple(haps.shape[1:]) != (H,) or tuple(reads.shape[1:]) != (R,):
        raise ValueError(f"want (B, {H}) haps and (B, {R}) reads, got "
                         f"{tuple(haps.shape)} and {tuple(reads.shape)}")
    B = reads.shape[0]
    pad = (-B) % min(8, B)
    if pad:
        def grow(x, value):
            return torch.cat([x, torch.full((pad,) + x.shape[1:], value,
                                            dtype=x.dtype,
                                            device=x.device)])
        haps, reads = grow(haps, HAP_PAD), grow(reads, READ_PAD)
        rlens, ms = grow(rlens, 1), grow(ms, 0)
    h_d, h_a, packed = fused_rows(haps, reads, rlens, ms,
                                  10 * (int(k_idx) + 1), scorer)
    return h_d[:B], h_a[:B], packed[:B]


# ---------------------------------------------------------------------------
# host-facing backend
# ---------------------------------------------------------------------------

class FusedStats:
    """Exact-integer host view of one fused batch (the packed rows cross
    to the host in one copy; the histograms stay on the device)."""

    def __init__(self, h_d, h_a, packed):
        self.h_d, self.h_a = h_d, h_a
        p = packed.cpu().numpy()
        self.n_dots = p[:, 0] + p[:, 1]
        self.i_min = p[:, 2]
        self.i_max = p[:, 3]
        self.cnt = p[:, 4]
        self.sum_absd = p[:, 5]
        self.w10 = p[:, 6]
        if p.shape[1] >= 10:   # combined DEL mode: within-10% set
            self.cnt2 = p[:, 7]
            self.sum_absd2 = p[:, 8]
            self.w10_2 = p[:, 9]

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

    name = "torch"

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
        haps = np.broadcast_to(hap_codes, (fw.shape[0], H))
        return _Ready(fused_batch(
            *batch_from_numpy(haps, fw, rlens, ms, window // 10 - 1,
                              self.device),
            H=H, R=R, scorer=scorer))

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
        if not (all(_VOCAB_OK[h].all() for h in haps)
                and all(_VOCAB_OK[enc[0]].all()
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
            su_ref = FusedStats(*d_ref_u.result())
            su_alt = FusedStats(*d_alt_u.result())
            sr_ref = FusedStats(*d_ref_r.result())
            sr_alt = FusedStats(*d_alt_r.result())
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

    def score_batch_async(self, scorer: str, ref_seq: str,
                          alt_seq: str, reads: Sequence[Sequence],
                          window: int):
        """Dispatches scoring without blocking; returns a zero-arg
        finisher.  redefine_diagonal raises: its device mode (rdd) is
        not ported yet, and no other route stands in for it."""
        if scorer == "redefine_diagonal":
            raise NotImplementedError(
                "redefine_diagonal needs the rdd device mode (kernels "
                "kept_hist and rdd_moment), which comes in the next "
                "slice of the port")
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
        mode = {"abs_dis_m1b": "m1b", "within_10perc_m1b": "w10"}[scorer]
        hr = self._encode_hap(ref_s, H_r)
        ha = self._encode_hap(alt_s, H_a)
        encs = [(idxs, self._encode_reads([reads[i] for i in idxs], R))
                for R, idxs in r_groups]
        if not (_VOCAB_OK[hr].all() and _VOCAB_OK[ha].all()
                and all(_VOCAB_OK[enc[0]].all()
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
            s_ref = FusedStats(*d_ref.result())
            s_alt = FusedStats(*d_alt.result())
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
        # w10
        if not max(float(nr) / float(len(ref_s)),
                   float(na) / float(len(alt_s))) > 0.1:
            return [0, 0]
        if int(s_ref.cnt[b]) > 0 and int(s_alt.cnt[b]) > 0:
            return [int(s_alt.w10[b]), int(s_ref.w10[b])]
        return [0, 0]
