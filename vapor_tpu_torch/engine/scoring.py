"""Scoring backends: the numpy oracle on the host, or the fused engine on
a torch device.

Validators request scores for a whole read list at once so the device
backend can batch (read x haplotype) pairs; the numpy backend simply
loops the oracle scorers.
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
    """'torch' (the fused engine on `device`, CUDA unless a device is
    given; raises when CUDA is asked for and absent) or 'numpy'."""
    if name == "numpy":
        return NumpyBackend()
    if name == "torch":
        from .fused import FusedBackend
        return FusedBackend("cuda" if device is None else device)
    raise ValueError(f"unknown backend {name!r}")
