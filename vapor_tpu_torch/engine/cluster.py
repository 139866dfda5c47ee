"""X-means / BIC clustering for the repeat-region QC.

Reimplements ``k_means_cluster`` / ``compute_bic`` / ``X_means_cluster``
(Simple_function.pyx:480-526, 856-906, 2101-2119).  The reference runs
sklearn k-means++ with *unseeded* randomness — its window-size decision in
repeat-heavy regions is nondeterministic run to run.  We keep the same
algorithm but seed it (random_state=0) so our output is reproducible; the
only observable effect is the repeat-QC mass used by the window tuner.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


def _log10_or_zero(x: float) -> float:
    """calcu_log10 (pyx:155-159): log10 with the log10(0) -> 0 quirk."""
    if x == 0:
        return 0.0
    return float(np.log10(x))


def compute_bic(centers: np.ndarray, labels: np.ndarray,
                X: np.ndarray, m: int) -> float:
    """Hand-rolled BIC of a k-means fit (pyx:480-517), including the
    negative-variance cluster guard (pyx:519-525)."""
    n = np.bincount(labels, minlength=m)
    N, d = X.shape
    cl_var: List[float] = []
    for i in range(m):
        pts = X[labels == i]
        sq = float(np.sum(np.sum((pts - centers[i]) ** 2, axis=1)))
        if n[i] - m != 0:
            cl_var.append((1.0 / (n[i] - m)) * sq)
        else:
            cl_var.append(1e20 * sq)
    const_term = 0.5 * m * _log10_or_zero(N)
    keep = [i for i, v in enumerate(cl_var) if not v < 0]
    ns = [int(n[i]) for i in keep]
    vs = [cl_var[i] for i in keep]
    terms = [
        ns[i] * _log10_or_zero(ns[i])
        - ns[i] * _log10_or_zero(N)
        - ((ns[i] * d) / 2) * _log10_or_zero(2 * np.pi)
        - (ns[i] / 2) * _log10_or_zero(vs[i])
        - ((ns[i] - m) / 2)
        for i in range(len(ns))
    ]
    return float(np.sum(terms) - const_term)


def _kmeanspp_init(X: np.ndarray, k: int,
                   rng: np.random.RandomState) -> np.ndarray:
    """k-means++ seeding (D^2 sampling)."""
    n = len(X)
    centers = np.empty((k, X.shape[1]))
    centers[0] = X[rng.randint(n)]
    d2 = ((X - centers[0]) ** 2).sum(axis=1)
    for c in range(1, k):
        total = d2.sum()
        if total <= 0:
            centers[c:] = X[rng.randint(n, size=k - c)]
            break
        probs = d2 / total
        centers[c] = X[rng.choice(n, p=probs)]
        d2 = np.minimum(d2, ((X - centers[c]) ** 2).sum(axis=1))
    return centers


def _kmeans_fit(X: np.ndarray, k: int, seed: int,
                n_init: int = 3, max_iter: int = 30):
    """Seeded numpy k-means++ (Lloyd).  Replaces the earlier
    sklearn.cluster.KMeans call: the repeat-QC X-means runs hundreds of
    small fits per repetitive haplotype (TANDUP alts are inherently
    self-repetitive), and sklearn's per-call overhead plus its one-time
    ~5 s import dominated per-process host cost.  The reference's own
    clusterer is UNSEEDED sklearn (pyx:861), so any deterministic
    clusterer is within the documented divergence; only the repeat-QC
    mass gate observes the result."""
    rng = np.random.RandomState(seed)
    best = None
    for _init in range(n_init):
        centers = _kmeanspp_init(X, k, rng)
        labels = None
        for _ in range(max_iter):
            d = ((X[:, None, :] - centers[None]) ** 2).sum(axis=2)
            new_labels = d.argmin(axis=1)
            if labels is not None and np.array_equal(new_labels, labels):
                break
            labels = new_labels
            for c in range(k):
                mask = labels == c
                if mask.any():
                    centers[c] = X[mask].mean(axis=0)
        inertia = float(((X - centers[labels]) ** 2).sum())
        if best is None or inertia < best[0]:
            best = (inertia, centers.copy(), labels.copy())
    return best[1], best[2]


def k_means_cluster(xs: Sequence[int], ys: Sequence[int], seed: int = 0
                    ) -> List[List[List[int]]]:
    """One BIC-guided k-means split (pyx:856-887).

    Input/output use the reference's [[xs], [ys]] pair-of-lists shape.
    Returns [[xs, ys]] unchanged when no split is warranted.
    """
    data_list = [list(xs), list(ys)]
    if not (max(data_list[0]) - min(data_list[0]) > 10
            and max(data_list[1]) - min(data_list[1]) > 10):
        return [data_list]
    X = np.array(list(zip(data_list[0], data_list[1])), dtype=float)
    ks = list(range(1, min(5, len(data_list[0]) + 1)))
    bic_vals, bic_ks = [], []
    for k in ks:
        centers, labels = _kmeans_fit(X, k, seed)
        if labels.max() < k - 1:
            continue
        b = compute_bic(centers, labels, X, k)
        if abs(b) < 1e8:
            bic_vals.append(b)
            bic_ks.append(k)
    if not bic_vals:
        return [data_list]
    k_pick = bic_ks[int(np.argmax(bic_vals))]
    if k_pick == 1:
        return [data_list]
    # final grouping via whitened k-means (pyx:878-885)
    std = X.std(axis=0)
    std[std == 0] = 1.0
    W = X / std
    rng = np.random.RandomState(seed)
    centroids = W[rng.choice(len(W), k_pick, replace=False)]
    for _ in range(20):
        dist = np.linalg.norm(W[:, None, :] - centroids[None], axis=2)
        idx = dist.argmin(axis=1)
        new_c = np.array([
            W[idx == c].mean(axis=0) if (idx == c).any() else centroids[c]
            for c in range(k_pick)])
        if np.allclose(new_c, centroids):
            break
        centroids = new_c
    out = []
    for c in range(k_pick):
        out.append([[int(v) for v in X[idx == c, 0]],
                    [int(v) for v in X[idx == c, 1]]])
    return out


def xmeans_cluster(xs: Sequence[int], ys: Sequence[int], seed: int = 0,
                   _depth: int = 0) -> List[List[int]]:
    """Recursive X-means (pyx:2101-2109) with a depth cap the reference
    lacks (it can, in principle, recurse forever on a stable split)."""
    result = [g for g in k_means_cluster(xs, ys, seed) if g != [[], []]]
    if _depth > 8 or (len(result) == 1 and result[0] == [list(xs), list(ys)]):
        flat: List[List[int]] = []
        for g in result:
            flat.extend(g)
        return flat
    flat = []
    for g in result:
        flat.extend(xmeans_cluster(g[0], g[1], seed, _depth + 1))
    return flat


def xmeans_cluster_pairs(xs: Sequence[int], ys: Sequence[int], seed: int = 0
                         ) -> List[List[List[int]]]:
    """X_means_cluster_reformat (pyx:2111-2116): [[xs, ys], ...]."""
    flat = xmeans_cluster(xs, ys, seed)
    return [[flat[2 * i], flat[2 * i + 1]] for i in range(len(flat) // 2)]
