"""The v1 scoring engine: dotplot statistics in skewed coordinates, as
dense torch ops on a device (``--backend torch-v1``).

It reaches the fused engine's answers by another route and shares no
device code with it:

* base equality in *skewed* layout: S[i, c] = read[i + c - (H-1)], a
  strided view of the padded read (no gather), so a k-mer match is a
  vertical run of k equal cells down one column, found with one
  ``torch.cummax`` pass (run length since the last mismatch) for any k;
* inverted (reverse-complement) matches run the same pipeline on the
  host-made reverse complement of the read; their dots live on columns
  of constant anti-diagonal;
* the hit matrices are walked in blocks of reads x skew columns, so a
  pass holds ~BLOCK_CELLS cells at a time whatever the bucket; each
  block's hits come out as coordinates and go straight into the pass's
  sums, HIT_CHUNK hits at a time, so a pass's memory is bounded by the
  block, never by the number of hits (a tandem repeat has a hit on
  every in-phase cell).  Every statistic is a sum over the hits:
  diagonal and anti-diagonal histograms are offset scatter-adds (the
  slope-2 groupings key hits by c + 2i), and the cluster keep-tables,
  made on the host from the histograms exactly like the oracle, are
  looked up per hit;
* every sum is exact in int64; the threshold gates (within-10%, > 0.1
  deviation) use the reference's exact integer rewrites (25|d| < 4i'
  etc.: the rational operands never fall inside the rounding window of
  the binary float constants).

The placements reproduce the layout of the v1 engine on the TPU bit for
bit, including where its ``dynamic_slice`` / ``dynamic_update_slice``
move a start index: a negative start counts from the axis' end, and a
start is clamped so the slice fits (a large ``m`` with a short read
reaches both, ``_clamp_start``).  Scalar outputs feed the host finisher in
``V1Backend``, which reproduces the numpy oracle's scores bit for bit.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import oracle
from .constants import HAP_BUCKETS, HAP_PAD, READ_PAD, bucket_for

__all__ = ["HAP_PAD", "READ_PAD", "KMAX", "HAP_BUCKETS", "bucket_for",
           "HapStats", "kept_table", "V1Backend"]

KMAX = 40

# cells (reads x hap rows x skew columns) of one dense block of a pass:
# ~20 bytes a cell while it is live (the equality and run-length
# matrices, cummax's values and indices)
BLOCK_CELLS = {"cuda": 1 << 26, "cpu": 1 << 21}
# hits one _dot_stats_one call takes (~15 int64 temporaries a hit)
HIT_CHUNK = {"cuda": 1 << 23, "cpu": 1 << 20}
# hits a haplotype keeps from its first pass for its later ones (24 bytes
# a hit); past it, each pass scans the hap again
HIT_CACHE = {"cuda": 1 << 25, "cpu": 1 << 21}

# the per-row integers of one pass, in the order of _dot_stats_batch's
# third output
STATS = ("n_dots", "i_min", "i_max", "cnt", "sum_absd", "w10", "sel_cnt",
         "sel_pos", "sel_neg")


def _hist_layout(H: int, R: int) -> Tuple[int, int, int]:
    """(WH, D_OFF, A_OFF): histogram size and value offsets.

    Bucket(d') = d' + D_OFF, bucket(a') = a' + A_OFF.  Sizes leave room
    for every *placement window* (including all-zero skew tails): the
    slope-2 groupings cover index ranges of width W + 2H - 2.
    """
    D_OFF = R + 3 * H - 3          # = lenG, keeps every placement start >= 0
    A_OFF = 2 * H + R
    WH = 2 * R + 4 * H + 1024
    return WH, D_OFF, A_OFF


def _clamp_start(start: torch.Tensor, n: int, size: int) -> torch.Tensor:
    """The start a dynamic (update) slice of length n into an axis of
    `size` uses on the TPU: a negative start counts from the axis' end
    (start + size), then the start is clamped so the slice fits."""
    start = torch.where(start < 0, start + size, start)
    return start.clamp(0, size - n)


def _skew_read(reads: torch.Tensor, H: int, c0: int, c1: int
               ) -> torch.Tensor:
    """(B, R) read codes -> the (B, c1 - c0, H) view T[b, c - c0, i] =
    S[b, i, c] = read[b, i + c - (H-1)] for skew columns c in [c0, c1),
    READ_PAD off the read.  Column-major, so each column's hap rows are
    contiguous for the scan down the column."""
    B = reads.shape[0]
    pad = torch.full((B, H), READ_PAD, dtype=reads.dtype,
                     device=reads.device)
    row = torch.cat([pad[:, : H - 1], reads, pad], dim=1)
    return row.unfold(1, H, 1)[:, c0:c1]


def _hits(hap: torch.Tensor, T: torch.Tensor, k: int) -> torch.Tensor:
    """K[b, c, i] = 1 iff a k-mer match starts at hap row i in skew column
    c, for rows i < H - s (s = k - 1, the row shift; later rows read the
    zero pad, never >= k >= 1).  The row floor m is applied to the hit
    coordinates (``_hit_blocks``).

    Run lengths via `i - cummax(last mismatch row)`; the run that ends
    at the window's tail row i + k - 1 must reach back to row i."""
    H = hap.shape[0]
    rows = torch.arange(H, dtype=torch.int16, device=hap.device)
    last_miss = torch.cummax(torch.where(hap == T, -1, rows), dim=2).values
    s = min(k - 1, KMAX)               # the row shift's start, as clamped
    # runlen[i + s] = i + s - last_miss[i + s] >= k
    return last_miss[:, :, s:] <= rows[: H - s] + (s - k)


def _hit_blocks(hap, codes, ms, k: int, H: int, R: int):
    """Yields (bb, ii, cc) int64, one block of ~BLOCK_CELLS cells at a
    time: read, hap row and skew column of every k-mer match of one
    strand's (B, R) read codes against the hap, rows i >= ms[bb].  A
    match from row i >= m on lies in rows >= m, so the floor filters the
    hits."""
    if k < 1:
        raise ValueError(f"k-mer size {k} < 1")
    B, W = codes.shape[0], R + H - 1
    nb, bw = _blocks(B, H, W, hap.device)
    for b0 in range(0, B, nb):
        b1 = min(B, b0 + nb)
        for c0 in range(0, W, bw):
            bb, cc, ii = _hits(hap, _skew_read(codes[b0:b1], H, c0,
                                               min(W, c0 + bw)),
                               k).nonzero(as_tuple=True)
            bb = bb + b0
            keep = ii >= ms[bb]
            yield bb[keep], ii[keep], cc[keep] + c0


def _slope2_group(ii: torch.Tensor, cc: torch.Tensor) -> torch.Tensor:
    """The slope-2 diagonal key u = c + 2i of each hit: G[u] = sum_i
    K[i, u - 2i] is a scatter-add of the hits at u."""
    return cc + 2 * ii


def _slope2_lookup(table: torch.Tensor, bb, ii, cc, t0, M: int,
                   flip: bool = False) -> torch.Tensor:
    """X[i, c] = table[(2i + c + t0) mod len(table)] at each hit (row bb
    of `table`; `flip` reads the table reversed), as the TPU engine's
    pad+reshape lays it out: its last row, i = M - 1, reads zeros from
    v = c + t0 >= len - 2M + 2 on."""
    WA = table.shape[1]
    v = cc + t0
    idx = _slope2_group(ii, v) % WA
    if flip:
        idx = WA - 1 - idx
    return table[bb, idx] & ~((ii == M - 1) & (v >= WA - 2 * M + 2))


def _dot_stats_one(out, rev: bool, bb, ii, cc, rows, k: int, H: int,
                   R: int, mode: str, use_masks: bool) -> None:
    """Adds one strand's hits (read bb, hap row ii, skew column cc,
    int64) to the pass's outputs.

    `rows` holds the per-read int64 inputs (rlen, m, z, or_mode) and the
    (B, WH) bool keep-tables dm/am over histogram buckets (d' + D_OFF,
    a' + A_OFF).  or_mode = 1: keep = dm | am (final cleaning); 0: keep
    = dm & am (histogram restriction passes, e.g. the within-10%
    leftover stage).  z: 2x the re-centering intercept for the
    directed-deviation sums.

    `mode` prunes the work:
      "hist" - masked histograms + gate scalars only;
      "m1b"  - kept count + sum|d| moments only;
      "w10"  - kept count + within-10% count;
      "rdd"  - kept count + directed-deviation selection sums;
      "all"  - everything (tests / entry point).
    """
    h_d, h_a, st = out
    rlen, m, z, om, dm, am = rows
    WH, D_OFF, A_OFF = _hist_layout(H, R)
    W = R + H - 1
    LG = W + 2 * H - 2                    # length of a slope-2 grouping
    want_hist = mode in ("hist", "all")
    mb = m[bb]
    C0 = rlen - k + (H - 1) + m           # per read
    # per-dot coordinates (i' = i - m on the sliced haplotype)
    ip = ii - mb
    if rev:
        d = C0[bb] - cc - 2 * ii          # j - i', slope -2
    else:
        d = cc - (H - 1) + mb             # j - i', per column

    # ---- gate statistics (independent of masks) ------------------------
    if want_hist:
        st["n_dots"].index_add_(0, bb, torch.ones_like(bb))
        st["i_min"].scatter_reduce_(0, bb, ii, "amin")
        st["i_max"].scatter_reduce_(0, bb, ii, "amax")

    # keep masks from bucket tables
    if use_masks:
        if rev:
            kd = _slope2_lookup(dm, bb, ii, cc, _clamp_start(
                WH - 1 - D_OFF - C0, W, WH + 2)[bb], H, flip=True)
            a_col = rlen - k + (H - 1) - m    # + A_OFF - c: i' + j
            ka = am[bb, (a_col[bb] - cc + A_OFF).clamp(0, WH - 1)]
        else:
            kd = dm[bb, (d + D_OFF).clamp(0, WH - 1)]
            ka = _slope2_lookup(am, bb, ii, cc, _clamp_start(
                A_OFF - (H - 1) - m, W, WH + 2)[bb], H)
        keep = torch.where(om[bb] > 0, kd | ka, kd & ka)
        bb, ii, cc, d, ip = (x[keep] for x in (bb, ii, cc, d, ip))

    ones = torch.ones_like(bb)
    # ---- masked histograms (for host-side gap clustering) --------------
    if want_hist:
        row0 = bb * WH
        u = _slope2_group(ii, cc)
        if rev:
            s2 = _clamp_start(C0 - (LG - 1) + D_OFF, LG, WH)
            h_d.index_add_(0, row0 + s2[bb] + LG - 1 - u, ones)
            C1 = rlen - k + (H - 1) - m
            s4 = _clamp_start(C1 - (W - 1) + A_OFF, W, WH)
            h_a.index_add_(0, row0 + s4[bb] + W - 1 - cc, ones)
        else:
            s1 = _clamp_start(m - (H - 1) + D_OFF, W, WH)
            h_d.index_add_(0, row0 + s1[bb] + cc, ones)
            s3 = _clamp_start(A_OFF - (H - 1) - m, LG, WH)
            h_a.index_add_(0, row0 + s3[bb] + u, ones)

    # ---- masked moments -------------------------------------------------
    if mode == "hist":
        return
    absd = d.abs()
    st["cnt"].index_add_(0, bb, ones)
    if mode in ("m1b", "all"):
        st["sum_absd"].index_add_(0, bb, absd)
    if mode in ("w10", "all"):
        # within-10%: i' > 0 and 25|d| < 4i' (== |d|/i' < 0.16 f64)
        st["w10"].index_add_(0, bb, ((ip > 0) & (25 * absd < 4 * ip)
                                     ).long())
    if mode in ("rdd", "all"):
        # directed-deviation selection on the re-centered dots:
        # dev > 0.1 with i0 = i' + z/2  ->  10|z-2d| > |2i'+z|
        # (denominator i0+1 when i0 == 0)
        zb = z[bb]
        val = zb - 2 * d
        t = 2 * ip + zb
        den = torch.where(t == 0, (t + 2).abs(), t.abs())
        sel = (10 * val.abs() > den).long()
        st["sel_cnt"].index_add_(0, bb, sel)
        st["sel_pos"].index_add_(0, bb, sel * val.clamp(min=0))
        st["sel_neg"].index_add_(0, bb, sel * (-val).clamp(min=0))


def _blocks(B: int, H: int, W: int, device: torch.device
            ) -> Tuple[int, int]:
    """(reads, skew columns) of one block: whole rows of several reads
    while they fit in BLOCK_CELLS, else column strips of one read."""
    cells = BLOCK_CELLS[device.type]
    if H * W <= cells:
        return max(1, min(B, cells // (H * W))), W
    return 1, max(1, cells // H)


def _dot_stats_batch(hap, reads, rcs, rlens, ms, dms, ams, or_modes, zs,
                     k: int, H: int, R: int, mode: str = "all",
                     use_masks: bool = True, hits=None):
    """One pass over a read batch against one haplotype, on the tensors'
    device.

    hap (H,) uint8; reads / rcs (B, R) uint8 forward and reverse-
    complement codes; rlens, ms, or_modes, zs (B,) int; dms / ams (B, WH)
    bool.  Returns (h_d, h_a, stats), int64: the (B, WH) diagonal and
    anti-diagonal histograms ((B, 1) zeros unless mode is "hist" or
    "all") and the (B, len(STATS)) per-row integers (the gate scalars
    n_dots, i_min, i_max are 0 unless the histograms are wanted, the
    moments 0 in mode "hist").

    `hits`: the (forward, reverse) hit blocks of these reads against
    this hap, where a caller has them from an earlier pass (the hits do
    not depend on the masks, the mode or z); else each strand's blocks
    are scanned here and summed as they come."""
    dev = hap.device
    B = reads.shape[0]
    WH, _, _ = _hist_layout(H, R)
    want_hist = mode in ("hist", "all")
    hw = WH if want_hist else 1
    h_d = torch.zeros(B * hw, dtype=torch.int64, device=dev)
    h_a = torch.zeros_like(h_d)
    st = {x: torch.zeros(B, dtype=torch.int64, device=dev) for x in STATS}
    if want_hist:
        st["i_min"].fill_(H + 1)
        st["i_max"].fill_(-1)
    ms = ms.long()
    rows = (rlens.long(), ms, zs.long(), or_modes.long(), dms.bool(),
            ams.bool())
    if hits is None:
        hits = tuple(_hit_blocks(hap, x, ms, k, H, R) for x in (reads, rcs))
    chunk = HIT_CHUNK[dev.type]
    for rev, blocks in enumerate(hits):
        for bb, ii, cc in blocks:
            for s in range(0, bb.numel(), chunk):
                _dot_stats_one((h_d, h_a, st), bool(rev), bb[s:s + chunk],
                               ii[s:s + chunk], cc[s:s + chunk], rows, k, H,
                               R, mode, use_masks)
    if not want_hist:
        for x in ("n_dots", "i_min", "i_max"):
            st[x].zero_()
    return (h_d.view(B, hw), h_a.view(B, hw),
            torch.stack([st[x] for x in STATS], dim=1))


class HapStats:
    """Host-side exact-integer view of one batched device pass."""

    def __init__(self, h_d, h_a, stats):
        self.h_d = np.asarray(h_d)
        self.h_a = np.asarray(h_a)
        s = np.asarray(stats, dtype=np.int64)
        for j, name in enumerate(STATS):
            setattr(self, name, s[:, j])

    def span(self, r: int) -> int:
        if self.n_dots[r] == 0:
            return 0
        return int(self.i_max[r] - self.i_min[r])


def kept_table(hist: np.ndarray, gap: int, thr: int,
               fallback_max: bool) -> np.ndarray:
    """Gap-cluster a histogram into a bool keep-table (host, exact).

    Same semantics as oracle._kept_value_mask on bucketized counts:
    distinct present values = nonzero buckets; clusters break at gaps
    >= `gap`; keep totals > thr, else (with fallback) totals == max.
    """
    out = np.zeros(hist.shape[0], dtype=bool)
    nz = np.nonzero(hist)[0]
    if nz.size == 0:
        return out
    breaks = np.nonzero(np.diff(nz) >= gap)[0]
    starts = np.concatenate([[0], breaks + 1])
    ends = np.concatenate([breaks, [nz.size - 1]])
    totals = np.array([hist[nz[s]:nz[e] + 1].sum()
                       for s, e in zip(starts, ends)], dtype=np.int64)
    keep = totals > thr
    if fallback_max and not keep.any():
        keep = totals == totals.max()
    for s, e, kp in zip(starts, ends, keep):
        if kp:
            out[nz[s]:nz[e] + 1] = True
    mask = np.zeros_like(out)
    mask[nz] = True
    return out & mask


class _Hap:
    """One haplotype's codes on the device and its hit blocks against the
    batch's reads, kept from its first pass for the later ones (which
    change masks, mode and z, never the hits) while they total at most
    `budget` hits; past it, every pass scans the hap again."""

    def __init__(self, codes: torch.Tensor, budget: int):
        self.codes = codes
        self.budget = budget
        self.kept = None

    def hits(self, fw, rc, ms, k: int, H: int, R: int):
        """The (forward, reverse) hit blocks: the kept ones, or a scan of
        each strand that keeps its blocks within the budget."""
        if self.kept is not None:
            return self.kept
        kept = ([], [])

        def scan(rev, codes):
            for block in _hit_blocks(self.codes, codes, ms, k, H, R):
                self.budget -= block[0].numel()
                if self.budget >= 0:
                    kept[rev].append(block)
                else:
                    kept[0].clear()
                    kept[1].clear()
                yield block
            if rev and self.budget >= 0:
                self.kept = kept
        return scan(0, fw), scan(1, rc)


class V1Backend:
    """The v1 engine on `device` with exact host finishing.

    score_batch() reproduces the oracle scorers bit-for-bit: the device
    returns exact integer aggregates; all float math happens here in f64
    with the same expressions the reference uses.
    """

    name = "torch-v1"

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("the torch-v1 backend was asked for CUDA, "
                               "but torch.cuda.is_available() is False")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        self._true_tables = {}

    # -- encoding ---------------------------------------------------------

    def _encode_hap(self, seq: str, H: int) -> np.ndarray:
        codes = oracle.encode(seq)
        out = np.full(H, HAP_PAD, dtype=np.uint8)
        out[: len(codes)] = codes
        return out

    def _encode_reads(self, reads: Sequence[Sequence], R: int):
        B = len(reads)
        fw = np.full((B, R), READ_PAD, dtype=np.uint8)
        rc = np.full((B, R), READ_PAD, dtype=np.uint8)
        rlens = np.zeros(B, dtype=np.int32)
        ms = np.zeros(B, dtype=np.int32)
        for b, r in enumerate(reads):
            codes = oracle.encode(r[0])
            fw[b, : len(codes)] = codes
            rc[b, : len(codes)] = oracle.encode_comp(r[0])[::-1]
            rlens[b] = len(codes)
            ms[b] = int(r[1])
        return fw, rc, rlens, ms

    def _all_true(self, WH: int) -> np.ndarray:
        if WH not in self._true_tables:
            self._true_tables[WH] = np.ones(WH, dtype=bool)
        return self._true_tables[WH]

    def _put(self, a) -> torch.Tensor:
        return torch.from_numpy(np.require(a, requirements="CW")).to(
            self.device)

    def _pass(self, hap: "_Hap", enc, k, H, R, dms=None, ams=None,
              or_mode=0, zs=None, mode="all",
              use_masks=True) -> HapStats:
        fw, rc, rlens, ms = enc
        B = fw.shape[0]
        WH, _, _ = _hist_layout(H, R)
        if dms is None:
            dms = np.broadcast_to(self._all_true(WH), (B, WH))
        if ams is None:
            ams = np.broadcast_to(self._all_true(WH), (B, WH))
        or_modes = np.full(B, or_mode, dtype=np.int32)
        if zs is None:
            zs = np.zeros(B, dtype=np.int32)
        h_d, h_a, stats = _dot_stats_batch(
            hap.codes, fw, rc, rlens, ms, self._put(dms), self._put(ams),
            self._put(or_modes), self._put(zs.astype(np.int32)), int(k),
            H=H, R=R, mode=mode, use_masks=use_masks,
            hits=hap.hits(fw, rc, ms.long(), k, H, R))
        return HapStats(h_d.cpu().numpy(), h_a.cpu().numpy(),
                        stats.cpu().numpy())

    # -- public API -------------------------------------------------------

    def score_batch(self, scorer: str, ref_seq: str, alt_seq: str,
                    reads: Sequence[Sequence], window: int
                    ) -> List[List[float]]:
        if not reads:
            return []
        if scorer in ("abs_dis_m1", "abs_dis_m2"):
            # legacy scorers (unused by the CLI) stay on the numpy oracle
            return [oracle.SCORERS[scorer](ref_seq, alt_seq, r[0], r[1],
                                           window) for r in reads]
        upper = scorer == "abs_dis_m1b"
        ref_s = ref_seq.upper() if upper else ref_seq
        alt_s = alt_seq.upper() if upper else alt_seq
        try:
            H = bucket_for(max(len(ref_s), len(alt_s)) + 1)
            R = bucket_for(max(len(r[0]) for r in reads) + 1)
        except ValueError:
            return [oracle.SCORERS[scorer](ref_seq, alt_seq, r[0], r[1],
                                           window) for r in reads]
        enc = tuple(self._put(x) for x in self._encode_reads(reads, R))
        budget = HIT_CACHE[self.device.type]
        ref_codes = _Hap(self._put(self._encode_hap(ref_s, H)), budget)
        alt_codes = _Hap(self._put(self._encode_hap(alt_s, H)), budget)
        if scorer == "abs_dis_m1b":
            return self._score_m1b(ref_codes, alt_codes, len(ref_s),
                                   len(alt_s), enc, window, H, R)
        if scorer == "within_10perc_m1b":
            return self._score_w10(ref_codes, alt_codes, len(ref_s),
                                   len(alt_s), enc, window, H, R)
        if scorer == "redefine_diagonal":
            return self._score_rdd(ref_codes, alt_codes, len(ref_s),
                                   len(alt_s), enc, window, H, R)
        raise ValueError(f"unknown scorer {scorer}")

    # -- per-scorer flows -------------------------------------------------

    def _clean_tables(self, st: HapStats, B: int, WH: int):
        """diag-and-anti cleaning tables (thr 10, no fallback)."""
        dms = np.zeros((B, WH), dtype=bool)
        ams = np.zeros((B, WH), dtype=bool)
        for b in range(B):
            dms[b] = kept_table(st.h_d[b], 10, 10, False)
            ams[b] = kept_table(st.h_a[b], 10, 10, False)
        return dms, ams

    def _score_m1b(self, ref_codes, alt_codes, ref_len, alt_len, enc,
                   window, H, R) -> List[List[float]]:
        WH, _, _ = _hist_layout(H, R)
        B = enc[0].shape[0]
        p_ref = self._pass(ref_codes, enc, window, H, R,
                           mode="hist", use_masks=False)
        p_alt = self._pass(alt_codes, enc, window, H, R,
                           mode="hist", use_masks=False)
        r_dm, r_am = self._clean_tables(p_ref, B, WH)
        a_dm, a_am = self._clean_tables(p_alt, B, WH)
        m_ref = self._pass(ref_codes, enc, window, H, R, r_dm, r_am, 1,
                           mode="m1b")
        m_alt = self._pass(alt_codes, enc, window, H, R, a_dm, a_am, 1,
                           mode="m1b")
        out = []
        for b in range(B):
            nr, na = int(p_ref.n_dots[b]), int(p_alt.n_dots[b])
            if not (nr > 2 and na > 2):
                out.append([0, 0])
                continue
            if not float(nr) / min(float(ref_len), float(alt_len)) > 0.1:
                out.append([0, 0])
                continue
            r_ok = float(p_ref.span(b)) / float(ref_len) > 0.6
            a_ok = float(p_alt.span(b)) / float(alt_len) > 0.6
            if not (r_ok and a_ok):
                out.append([1.1, 2.1] if r_ok else
                           ([2.1, 1.1] if a_ok else [0, 0]))
                continue
            cr, ca = int(m_ref.cnt[b]), int(m_alt.cnt[b])
            if cr > 0 and ca > 0:
                out.append([float(m_ref.sum_absd[b]) / cr,
                            float(m_alt.sum_absd[b]) / ca])
            else:
                out.append([0, 0])
        return out

    def _score_w10(self, ref_codes, alt_codes, ref_len, alt_len, enc,
                   window, H, R) -> List[List[float]]:
        WH, _, _ = _hist_layout(H, R)
        B = enc[0].shape[0]
        p_ref = self._pass(ref_codes, enc, window, H, R,
                           mode="hist", use_masks=False)
        p_alt = self._pass(alt_codes, enc, window, H, R,
                           mode="hist", use_masks=False)

        def d50(p):
            t = np.zeros((B, WH), dtype=bool)
            for b in range(B):
                t[b] = kept_table(p.h_d[b], 10, 50, True)
            return t

        r_d50, a_d50 = d50(p_ref), d50(p_alt)
        # leftover stage: anti histogram of dots with d NOT kept
        l_ref = self._pass(ref_codes, enc, window, H, R, ~r_d50, None, 0,
                           mode="hist")
        l_alt = self._pass(alt_codes, enc, window, H, R, ~a_d50, None, 0,
                           mode="hist")
        r_a50 = np.zeros((B, WH), dtype=bool)
        a_a50 = np.zeros((B, WH), dtype=bool)
        for b in range(B):
            r_a50[b] = kept_table(l_ref.h_a[b], 10, 50, True)
            a_a50[b] = kept_table(l_alt.h_a[b], 10, 50, True)
        m_ref = self._pass(ref_codes, enc, window, H, R, r_d50, r_a50, 1,
                           mode="w10")
        m_alt = self._pass(alt_codes, enc, window, H, R, a_d50, a_a50, 1,
                           mode="w10")
        out = []
        for b in range(B):
            nr, na = int(p_ref.n_dots[b]), int(p_alt.n_dots[b])
            if not max(float(nr) / float(ref_len),
                       float(na) / float(alt_len)) > 0.1:
                out.append([0, 0])
                continue
            if int(m_ref.cnt[b]) > 0 and int(m_alt.cnt[b]) > 0:
                # [alt, ref] ordering (pyx:290)
                out.append([int(m_alt.w10[b]), int(m_ref.w10[b])])
            else:
                out.append([0, 0])
        return out

    def _score_rdd(self, ref_codes, alt_codes, ref_len, alt_len, enc,
                   window, H, R) -> List[List[float]]:
        WH, D_OFF, _ = _hist_layout(H, R)
        B = enc[0].shape[0]
        p_ref = self._pass(ref_codes, enc, window, H, R,
                           mode="hist", use_masks=False)
        p_alt = self._pass(alt_codes, enc, window, H, R,
                           mode="hist", use_masks=False)
        r_dm, r_am = self._clean_tables(p_ref, B, WH)
        a_dm, a_am = self._clean_tables(p_alt, B, WH)
        # cleaned-only histograms feed the intercept search; the kept
        # count doubles as the "cleaned nonempty" gate
        c_ref = self._pass(ref_codes, enc, window, H, R, r_dm, r_am, 1,
                           mode="hist")
        c_alt = self._pass(alt_codes, enc, window, H, R, a_dm, a_am, 1,
                           mode="hist")

        def intercepts(c):
            zs = np.zeros(B, dtype=np.int32)
            for b in range(B):
                h = c.h_d[b]
                nz = np.nonzero(h)[0]
                if nz.size == 0:
                    continue
                vals = np.repeat(nz - D_OFF, h[nz]).astype(np.int64)
                cc = oracle.most_abundant_intercept(
                    np.zeros_like(vals), vals, np.ones_like(vals))
                zs[b] = np.int32(round(2 * cc))
            return zs

        r_z = intercepts(c_ref)
        a_z = intercepts(c_alt)
        s_ref = self._pass(ref_codes, enc, window, H, R, r_dm, r_am, 1,
                           zs=r_z, mode="rdd")
        s_alt = self._pass(alt_codes, enc, window, H, R, a_dm, a_am, 1,
                           zs=a_z, mode="rdd")
        out = []
        for b in range(B):
            nr, na = int(p_ref.n_dots[b]), int(p_alt.n_dots[b])
            if not (float(nr) / float(ref_len) > 0.1 and
                    float(na) / float(alt_len) > 0.1):
                out.append([0, 0])
                continue
            if not (float(p_ref.span(b)) / float(ref_len) > 0.7 and
                    float(p_alt.span(b)) / float(alt_len) > 0.7):
                out.append([0, 0])
                continue
            if int(c_ref.h_d[b].sum()) == 0 or \
                    int(c_alt.h_d[b].sum()) == 0:
                out.append([0, 0])
                continue
            pair = []
            for s in (s_ref, s_alt):
                n_sel = int(s.sel_cnt[b])
                if n_sel == 0:
                    pair.append(0.0001)
                else:
                    total = float(int(s.sel_pos[b]) - int(s.sel_neg[b]))
                    pair.append(abs((total / 2.0) / n_sel))
            out.append(pair)
        return out
