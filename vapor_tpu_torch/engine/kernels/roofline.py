"""The least time an H100 could take for the kernels' work.

A bound is the larger of two times: the bytes a function must move (each
input read once, each output written once) over the card's memory rate,
and the operations it does over the card's 32-bit integer rate.  The
kernels compare packed int32 k-mer codes and accumulate integers, so
INT32 is the rate that applies.
"""
from __future__ import annotations

import subprocess
from typing import Dict, Mapping, Sequence, Tuple

# Peak rates of one H100 SXM at the 700 W limit: HBM bytes/s (NVIDIA data
# sheet), and 32-bit integer operations/s, 132 SMs x 64 INT32 lanes x the
# 1.98 GHz boost clock: a quarter of the sheet's 67 TFLOP/s FP32 rate,
# which counts 128 lanes per SM and an FMA as two operations.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# per-hit accumulations of each wrapper's kernel route, beside the
# compares: 2 per eligible cell (lane 0 of both strands), and lanes - 1
# more per hit
HIT_OPS = {"hist": 4, "hist_self": 3, "left_hist": 1, "kept_hist": 1,
           "moment": 3, "moment2": 5, "rdd_moment": 5}


def card_line() -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader` prints them (first card): a
    card set below 700 W runs slower than these rates under load."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def bound(nbytes: float, ops: float) -> Tuple[float, str]:
    """(least ms for nbytes moved and ops done, "bytes" or
    "operations", whichever sets it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes > t_ops else "operations"


def tensor_bytes(tensors: Sequence) -> int:
    """Bytes of the tensors, each distinct one counted once: a function
    given the same tensor twice needs to move it only once."""
    return sum(n * size for _, n, size in {
        (t.data_ptr(), t.numel(), t.element_size()) for t in tensors})


def kernel_work(name: str, codes, hap_lens: Sequence[int], outs,
                tables, hits: int) -> Tuple[int, int]:
    """(bytes, operations) of one call of wrapper `name` on `codes` =
    (ch, cf, cd, ms, rlens, k) with hap rows of hap_lens bytes, its
    outputs outs, its tables (keep tables, intercepts) and `hits` hit
    cells.  Cells that can hit: hap rows m..hap_len - k (a later row's
    k-mer holds HAP_PAD, which no read k-mer does) by read columns
    0..rlen - k."""
    ch, cf, cd, ms, rlens, k = codes
    R = cf.shape[2]
    lanes = ch.shape[1]
    cells = sum(max(0, n - k + 1 - m) * max(0, min(rl - k, R - 1) + 1)
                for n, m, rl in zip(hap_lens, ms.tolist(), rlens.tolist()))
    ops = cells * 2 + hits * (lanes - 1 + HIT_OPS[name])
    return tensor_bytes((ch, cf, cd, ms, rlens, *tables, *outs)), ops


# integer operations per histogram bin of a keep table (is it nonzero, is
# it a cluster start, its add to the cluster's total, the keep test) and
# of an intercept's first pass (its add to the row's sum, is it nonzero,
# the min and max); a nonzero bin of an intercept row is also binned
# (ten compares, ten multiplies, two adds)
KEPT_OPS_PER_BIN = 4
INTERCEPT_OPS_PER_BIN = 3
INTERCEPT_OPS_PER_VALUE = 22


def codes_work(haps, reads, rlens, outs, k: int, hap_index=None
               ) -> Tuple[int, int]:
    """(bytes, operations) of row_codes: hap and read bytes, lengths (and
    hap_index) in, the three code arrays `outs` out; a shift and an or
    per symbol of each k-mer window of the hap rows, the reads and their
    reverse strands."""
    ch, cf, _ = outs
    ins = (haps, reads, rlens) + (() if hap_index is None else (hap_index,))
    return (tensor_bytes((*ins, *outs)),
            2 * k * (ch.shape[0] * ch.shape[2] + 2 * cf.shape[0] *
                     cf.shape[2]))


def kept_tables_work(hs, outs) -> Tuple[int, int]:
    """(bytes, operations) of one kept_tables call: each table's (B, W)
    histogram in, its (B, W) bool table out; KEPT_OPS_PER_BIN a bin."""
    return (tensor_bytes((*hs, *outs)),
            KEPT_OPS_PER_BIN * sum(h.numel() for h in hs))


def intercept_work(h, outs) -> Tuple[int, int]:
    """(bytes, operations) of one intercept_z call: the (B, W) histogram
    in, found and z out; INTERCEPT_OPS_PER_BIN a bin and
    INTERCEPT_OPS_PER_VALUE a nonzero bin (this call's data)."""
    return (tensor_bytes((h, *outs)),
            INTERCEPT_OPS_PER_BIN * h.numel() +
            INTERCEPT_OPS_PER_VALUE * int((h > 0).sum()))


def lost_ms(launch_shapes: Mapping[tuple, int], device_ms: Mapping,
            bound_ms: Mapping) -> Dict[Tuple[str, str], float]:
    """Launch-weighted device time over the bound, by (kernel, route):
    the sum over the (name, route, H, R) keys of launch_shapes (as
    kernels.LAUNCH_SHAPES counts them) of launches x (device_ms[key] -
    bound_ms[key]).  A launched key with no time raises KeyError."""
    lost: Dict[Tuple[str, str], float] = {}
    for key, n in launch_shapes.items():
        name, route = key[:2]
        lost[name, route] = lost.get((name, route), 0.0) + \
            n * (device_ms[key] - bound_ms[key])
    return lost
