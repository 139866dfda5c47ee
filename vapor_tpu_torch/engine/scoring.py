"""Scoring backends: the numpy oracle on the host, or the fused engine
(or the v1 dense engine) on a torch device.

Validators request scores for a whole read list at once so the device
backend can batch (read x haplotype) pairs, across events too
(engine/batching.py); the numpy backend simply loops the oracle
scorers.
"""
from __future__ import annotations

from typing import List, Sequence

from . import oracle


class NumpyBackend:
    """Per-read vectorized numpy scoring (host)."""

    name = "numpy"

    def score_batch(self, scorer: str, ref_seq: str, alt_seq: str,
                    reads: Sequence[Sequence], window: int
                    ) -> List[List[float]]:
        fn = oracle.SCORERS[scorer]
        return [fn(ref_seq, alt_seq, r[0], r[1], window) for r in reads]


def get_backend(name: str = "torch", device=None):
    """'torch' (the fused engine behind the cross-event batching
    backend), 'torch-nobatch' (the fused engine, one launch per
    request), 'torch-v1' (the v1 dense engine, engine/kernel.py) or
    'numpy'.  The torch backends run on `device`, CUDA unless a device
    is given, and raise when CUDA is asked for and absent."""
    if name == "numpy":
        return NumpyBackend()
    device = "cuda" if device is None else device
    if name == "torch":
        from .batching import BatchingBackend
        return BatchingBackend(device)
    if name == "torch-nobatch":
        from .fused import FusedBackend
        return FusedBackend(device)
    if name == "torch-v1":
        from .kernel import V1Backend
        return V1Backend(device)
    raise ValueError(f"unknown backend {name!r}")
