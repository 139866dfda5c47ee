"""QS/GS aggregation and maximum-likelihood genotyping.

Ports ``result_organize_ins`` (pyx:1219-1231),
``gt_estimate_log_likelihood`` (pyx:2054-2069) and
``log_likelihood_calcu`` (pyx:2071-2077) exactly, including:

* QS = mean of strictly-positive per-read scores (0 if none),
  GS = fraction of positive scores;
* the recurrence string carries scores rounded to 2 decimals, and the
  genotyper re-parses *those rounded values* (so GT/GQ depend on the
  printed precision, not the raw scores);
* the binomial error model with err=0.05 accumulated by repeated
  addition (kept for bit-identical floats);
* GQ = -log10(median of normalized likelihoods), and the 0/0 -> 0/1
  override when GS > 0.15.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


def organize_result(key: str, scores: Sequence[float]) -> List:
    """[key, QS, GS, rec_string] or [key, 'NA', 'NA', 'NA']."""
    if len(scores) > 0:
        pos = [s for s in scores if float(s) > 0]
        neg = [s for s in scores if not float(s) > 0]
        gs = float(len(pos)) / float(len(pos) + len(neg))
        qs = np.mean(pos) if pos else 0
        rec = ",".join(str(round(float(s), 2)) for s in scores)
        return [key, qs, gs, rec]
    return [key, "NA", "NA", "NA"]


def _log_likelihood(k: int, l: int, m: int, g: int,
                    err: float = 0.05) -> float:
    out = -k * np.log(m)
    for _ in range(l):
        out += np.log((m - g) * err + g * (1 - err))
    for _ in range(k - l):
        out += np.log((m - g) * (1 - err) + g * err)
    return out


def estimate_genotype(result_row: Sequence) -> List:
    """[GT, GQ] from a result row ending in (..., GS, rec_string)."""
    read_scores = [float(s) for s in str(result_row[-1]).split(",")]
    k = len(read_scores)
    l = len([s for s in read_scores if not s > 0])
    m = 2
    gt_list = ["0/0", "0/1", "1/1"]
    gt_score = [_log_likelihood(k, l, m, 2),
                _log_likelihood(k, l, m, 1),
                _log_likelihood(k, l, m, 0)]
    top = max(gt_score)
    ori = [np.exp(s - top) for s in gt_score]
    norm = [s / sum(ori) for s in ori]
    with np.errstate(divide="ignore"):
        gq = -np.log(np.median(norm)) / np.log(10)
    gt = gt_list[gt_score.index(top)]
    if gt == "0/0" and result_row[-2] > 0.15:
        gt = "0/1"
    return [gt, gq]
