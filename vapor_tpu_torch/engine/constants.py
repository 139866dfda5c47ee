"""Shared engine constants: pad sentinels, haplotype length buckets and
the engine alphabet with its 4-bit symbols.

Both pads never equal a real post-key_modify ASCII code or each other, so
a k-mer window that runs into padding matches nothing on the other side.
"""
from __future__ import annotations

import numpy as np

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


# The engine alphabet: every code the CLI paths can produce (key_modify
# collapses IUPAC to N/n), the INS 'X' placeholder and '=', and the three
# never-matching sentinels.  Backends check sequences against VOCAB_OK
# and score through the oracle otherwise.
VOCAB = np.frombuffer(b"ACGTNacgtn", dtype=np.uint8)
VOCAB_OK = np.zeros(256, dtype=bool)
VOCAB_OK[VOCAB] = True
for _c in b"Xx=":
    VOCAB_OK[_c] = True
VOCAB_OK[HAP_PAD] = VOCAB_OK[READ_PAD] = VOCAB_OK[0xFE] = True

# 4-bit symbol of each admitted byte.  Injective on the 16 bytes of
# VOCAB_OK; windows running past a sequence end pick up side-specific
# pad symbols, so cross-side matches there are impossible.  csrc/codes.cu
# holds the same table.
NIB_BYTES = bytes(VOCAB) + b"Xx=" + bytes([HAP_PAD, READ_PAD, 0xFE])
NIB_LUT = np.full(256, 15, dtype=np.int64)
for _i, _c in enumerate(NIB_BYTES):
    NIB_LUT[_c] = _i
