"""Window-size refinement with the self-comparison on the card.

The adaptive window tuner self-compares the haplotype (pyx:2030-2046);
on haplotypes up to ~13 kb that is an O(L^2) dotplot per event.  Here
the hap goes through the ``hist`` kernel's self-stats route as its own
read, which reduces the row to three integers of its diagonal
histogram:

* total          = every hit, both strands;
* diagonal count = bin H (i == j);
* below-diagonal = the bins below H (i > j).

The X-means repeat-mass check is needed only when the below-diagonal
fraction is in (0.1, 0.5): that case runs the exact host QC (numpy dots
and seeded X-means) on a worker thread; everything else is decided from
the three integers, exactly like the reference's gate.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..utils import trace
from ..utils.coro import drain
from . import kernels, oracle
from .constants import HAP_PAD, READ_PAD, VOCAB_OK, bucket_for
from .fused import row_codes
from .window import (qual_check_repetitive_region, self_dot_arrays,
                     window_size_refine)

# How often refinement leaves the device path: the (0.1, 0.5)
# below-diagonal band runs the host QC (band_hits), a hap too long for
# the largest bucket and a hap with a byte outside the engine alphabet
# take the exact host refiner (unbucketable_host_refines,
# vocab_host_refines: pack_codes maps every such byte to one symbol, so
# two different ones would match).
BAND_STATS = {"refine_calls": 0, "stat_rounds": 0, "band_hits": 0,
              "unbucketable_host_refines": 0, "vocab_host_refines": 0}


def self_stats_rows(haps: torch.Tensor, lengths: torch.Tensor, k: int
                    ) -> torch.Tensor:
    """(B, H) uint8 hap rows (codes, then HAP_PAD) and their (B,) int32
    lengths -> (B, 3) int64 [total, diag, below] of each hap against
    itself at k-mer size k, on the haps' device.

    The hap is passed to ``kernels.hist_self`` (hist's self-stats route)
    as its own read: the read row is the hap's codes followed by READ_PAD,
    with m = 0 and rlen = length, and the route sums each row's hits
    straight into the three integers.  Hap rows past length - k hold
    HAP_PAD symbols and read columns past it are ineligible, so the pad
    block never self-matches; the reverse strand is derive_rc_rows'
    complement with its READ_PAD tail, which matches no HAP_PAD window
    either."""
    cols = torch.arange(haps.shape[1], device=haps.device)
    reads = torch.where(cols < lengths[:, None].long(), haps,
                        torch.full_like(haps, READ_PAD))
    return kernels.hist_self(*row_codes(haps, reads, lengths, k),
                             torch.zeros_like(lengths), lengths, k)


class DeviceWindowRefiner:
    """window_size_refine with the self-dotplot on a torch device."""

    def __init__(self, region_qc_cff: float = 0.4, seed: int = 0,
                 submit=None, device="cuda"):
        self.region_qc_cff = region_qc_cff
        self.seed = seed
        # submit(hap, length, window, H) -> future of a (3,) row: when
        # set (BatchingBackend.submit_selfstats), refiner steps of
        # pipelined events share launches with each other and with the
        # score rows
        self._submit = submit
        self.device = torch.device(device)

    def _stats_async(self, hap: np.ndarray, length: int, window: int):
        """Launch the self-comparison; returns a zero-arg finisher
        producing (total, diag, below)."""
        if self._submit is not None:
            fut = self._submit(hap, length, window, hap.shape[0])
            return lambda: tuple(int(v) for v in fut.result())
        row = self_stats_rows(
            torch.from_numpy(hap[None]).to(self.device),
            torch.tensor([length], dtype=torch.int32, device=self.device),
            window)
        return lambda: tuple(int(v) for v in row[0].tolist())

    def refine(self, seq: str) -> Optional[int]:
        return drain(self.refine_gen(seq))

    def refine_gen(self, seq: str):
        """Generator form of refine: yields zero-arg finishers for each
        device round trip and each band QC, so a cooperative scheduler
        (utils/coro.py) can overlap events (the control flow of
        window_size_refine).  Its host work between two yields is one
        ``refine`` span each."""
        with trace.span("refine"):
            seq = seq.replace("X", "")
            if seq.count("N") + seq.count("n") > 100:
                return None
            BAND_STATS["refine_calls"] += 1
            try:
                H = bucket_for(len(seq) + 1)
            except ValueError:
                BAND_STATS["unbucketable_host_refines"] += 1
                trace.count("refine.host")
                return _host_refine(seq, self.region_qc_cff, self.seed)
            codes = oracle.encode(seq)
            if not VOCAB_OK[codes].all():
                BAND_STATS["vocab_host_refines"] += 1
                trace.count("refine.host")
                return _host_refine(seq, self.region_qc_cff, self.seed)
            hap = np.full(H, HAP_PAD, dtype=np.uint8)
            hap[: len(codes)] = codes
            window = 10
            BAND_STATS["stat_rounds"] += 1
            fin = self._stats_async(hap, len(codes), window)
        total, diag, below = yield fin
        if total == 0:
            return None
        # size_cluster is [0] outside the (0.1, 0.5) band -> the mass
        # test fails -> the window stands
        while window <= 30 and diag / total <= self.region_qc_cff and \
                0.1 < below / total < 0.5:
            # repeat-heavy case (tandem arrays, DUP alt haps): the exact
            # host QC, on a worker thread whose Future.result the
            # pipeline resolves like any device finisher
            with trace.span("refine"):
                BAND_STATS["band_hits"] += 1
                fin = _qc_pool().submit(_band_qc, window, seq,
                                        self.seed).result
            qc = yield fin
            if qc[0] > self.region_qc_cff or \
                    sum(qc[1]) / len(seq) < 0.3:
                break
            with trace.span("refine"):
                window += 10
                BAND_STATS["stat_rounds"] += 1
                fin = self._stats_async(hap, len(codes), window)
            total, diag, below = yield fin
            if total == 0:
                break
        return window


def _host_refine(seq: str, cff: float, seed: int) -> Optional[int]:
    return window_size_refine(seq, cff, seed)[0]


_QC_POOL = None


def _qc_pool():
    """Worker pool of the band-QC host leg (2 workers: two in-flight band
    events overlap; more would contend for the interpreter lock)."""
    global _QC_POOL
    if _QC_POOL is None:
        from concurrent.futures import ThreadPoolExecutor
        _QC_POOL = ThreadPoolExecutor(max_workers=2,
                                      thread_name_prefix="vapor-band-qc")
    return _QC_POOL


def _band_qc(window: int, seq: str, seed: int) -> Tuple:
    ii, jj, ww = self_dot_arrays(window, seq)
    return qual_check_repetitive_region(ii, jj, ww, seed)
