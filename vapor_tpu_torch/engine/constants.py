"""Shared engine constants: pad sentinels and haplotype length buckets.

Both pads never equal a real post-key_modify ASCII code or each other, so
a k-mer window that runs into padding matches nothing on the other side.
"""
from __future__ import annotations

HAP_PAD = 255
READ_PAD = 253

# step ~1.25-1.5x: padding waste stays under ~50% in cells while the
# number of distinct shapes stays small.  Typical whole-event
# haplotypes (<= 10 kb SV + 2x500 flank) land in 1536-4096; junction
# mode is 1536-2048.
HAP_BUCKETS = (512, 768, 1024, 1536, 2048, 2560, 3072, 4096, 5120,
               6144, 8192, 10240, 12544, 16384)


def hist_width(H: int, R: int) -> int:
    """Histogram width of an (H, R) row: bins j - i + H and j + i both
    reach at most H + R - 2."""
    return -(-(H + R + 2) // 128) * 128


def bucket_for(n: int) -> int:
    for b in HAP_BUCKETS:
        if n <= b:
            return b
    raise ValueError(f"sequence of length {n} exceeds largest bucket")
