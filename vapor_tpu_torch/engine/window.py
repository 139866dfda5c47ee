"""Adaptive k-mer window selection + repetitive-region QC.

Port of ``window_size_refine`` (pyx:2030-2046) and
``qual_check_repetitive_region`` (pyx:1154-1171): a self-dotplot at
window 10 measures how repetitive the haplotype is; if the exact-diagonal
fraction is <= 0.4 *and* the off-diagonal X-means cluster mass is >= 0.3
of the sequence length, the window is bumped by 10 and re-checked, up to
window 40.  Sequences with > 100 Ns or an empty self-dotplot are
unevaluable and the event degrades to NA.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from . import oracle
from .cluster import xmeans_cluster_pairs


def self_dot_arrays(window: int, seq: str
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    ii, jj, ww, _, _ = oracle.dot_arrays(window, seq, seq)
    return ii, jj, ww


def qual_check_repetitive_region(ii: np.ndarray, jj: np.ndarray,
                                 ww: np.ndarray, seed: int = 0
                                 ) -> Tuple[float, List[float]]:
    """(diagonal fraction, off-diagonal cluster sizes) — pyx:1154-1171.

    Dots with i > j (strictly below the diagonal) feed the X-means
    clustering; each cluster contributes sqrt(x_extent * y_extent).
    """
    total = int(ww.sum())
    diag = int(ww[ii == jj].sum()) if ii.size else 0
    below = ii > jj
    n_below = int(ww[below].sum())
    frac_below = n_below / total if total else 0.0
    if total > 0 and 0.1 < frac_below < 0.5:
        xs = np.repeat(ii[below], ww[below]).tolist()
        ys = np.repeat(jj[below], ww[below]).tolist()
        clusters = xmeans_cluster_pairs(xs, ys, seed)
        sizes = []
        for cx, cy in clusters:
            extent = (max(cx) - min(cx)) * (max(cy) - min(cy))
            sizes.append(math.sqrt(extent))
    else:
        sizes = [0.0]
    return (diag / total if total else 0.0, sizes)


def window_size_refine(seq: str, region_qc_cff: float = 0.4,
                       seed: int = 0
                       ) -> Tuple[Optional[int], Optional[Tuple]]:
    """(window, qc) or (None, None) for unevaluable sequences.

    'X' placeholder bases (unknown INS sequence) are stripped before the
    self-check (pyx:2032); the reference returns the string 'Error' where
    we return None.
    """
    seq = seq.replace("X", "")
    if seq.count("N") + seq.count("n") > 100:
        return None, None
    window = 10
    ii, jj, ww = self_dot_arrays(window, seq)
    if ww.sum() == 0:
        return None, None
    qc = qual_check_repetitive_region(ii, jj, ww, seed)
    while True:
        if window > 30:
            break
        if qc[0] > region_qc_cff or sum(qc[1]) / len(seq) < 0.3:
            break
        window += 10
        ii, jj, ww = self_dot_arrays(window, seq)
        qc = qual_check_repetitive_region(ii, jj, ww, seed)
    return window, qc
