"""Rows across devices: one ``fused_batch`` call's rows split over cards.

The reference scales only by per-contig WDL scatter with file-based
merge (SURVEY §2.5, wdl/VaPoRVcf.wdl:44-77).  Here every ``fused_batch``
call (the single scoring entry of the CLI backends and the batching
backend) splits its (read x haplotype) rows over the visible cards
whenever there are several: each part runs the same one-device launch
on its own card and stream, and the packed rows come back in row order.
Per-row math is integer-exact and no row depends on another, so the
packed rows are bit-identical at any device count
(tests/test_torch_mesh.py).  No collective is needed: the JAX package's
per-call ``psum`` of the dot totals is never read.  Only a process that
is alone on the host splits: a torchrun rank or a scatter shard
(parallel.multihost.one_of_several) already has a card of its own, and
keeps its rows there.

Why rows only: one row's state is a few (W,) histograms and an (H, R)
cell walk that never leaves the card, far under one card's memory, so
splitting inside a row (an ``sp`` axis over read columns or histogram
bins) buys nothing and costs a merge per stage.  ``make_mesh`` still
takes an explicit (dp, sp) factorisation for experiments.

Multi-host: each process shards the worklist by contig
(parallel.multihost) and only fixed-width result rows cross processes.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..engine.constants import HAP_PAD, READ_PAD
from .multihost import one_of_several

ROW_GROUP = 8       # fused_batch's row group: each part is a multiple

# (card, part) -> the stream that part runs on.  The caching allocator
# keeps freed blocks per stream, so a fresh stream for every call finds
# none of them and allocates anew: two streams of one H100 took 3.3-5.4x
# one launch's time that way, 1.5-2.0x with the streams kept (PERF.md
# section 6).
_STREAMS: Dict[Tuple[torch.device, int], "torch.cuda.Stream"] = {}


def device_count() -> int:
    """Cards the split may span: torch.cuda.device_count() (0 without a
    card).  VAPOR_MESH_DEVICES caps it; VAPOR_MESH=0 turns the split
    off (1)."""
    if os.environ.get("VAPOR_MESH", "1") == "0":
        return 1
    n = torch.cuda.device_count()
    cap = os.environ.get("VAPOR_MESH_DEVICES")
    if cap:
        n = min(n, max(1, int(cap)))
    return n


def mesh_devices(device: torch.device) -> List[torch.device]:
    """The devices fused_batch splits the rows of tensors on `device`
    over: every card device_count() allows for CUDA tensors, none for
    CPU tensors; only `device` itself in a process that is one of
    several (its rank's or shard's card)."""
    if device.type != "cuda":
        return []
    if one_of_several():
        return [device]
    return [torch.device("cuda", i) for i in range(device_count())]


def make_mesh(n_devices: int, dp: int = 0, sp: int = 0,
              devices: Optional[Sequence[torch.device]] = None
              ) -> List[List[torch.device]]:
    """(dp, sp) grid over the first n_devices of `devices` (default: the
    visible cards), as dp lists of sp devices.

    The default is dp = n_devices, sp = 1: rows are independent, so row
    parallelism is the only axis that pays (see the module docstring).
    Explicit dp/sp must factor n_devices exactly."""
    if dp == 0 and sp == 0:
        dp, sp = n_devices, 1
    elif dp == 0:
        dp = n_devices // sp
    elif sp == 0:
        sp = n_devices // dp
    if dp * sp != n_devices or dp < 1 or sp < 1:
        raise ValueError(
            f"dp ({dp}) x sp ({sp}) must equal n_devices ({n_devices})")
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    if len(devices) < n_devices:
        raise ValueError(f"{n_devices} devices asked for, {len(devices)} "
                         f"available")
    return [list(devices[r * sp:(r + 1) * sp]) for r in range(dp)]


def _grow(x: torch.Tensor, n: int, value) -> torch.Tensor:
    return torch.cat([x, torch.full((n,) + x.shape[1:], value,
                                    dtype=x.dtype, device=x.device)])


def _part(haps, reads, rlens, ms, hap_index, rows: slice):
    """One part's rows; with hap_index, only the hap rows the part's
    rows use, and the part's hap_index re-based onto them."""
    if hap_index is None:
        return haps[rows], reads[rows], rlens[rows], ms[rows], None
    used, idx = torch.unique(hap_index[rows], return_inverse=True)
    return (haps.index_select(0, used), reads[rows], rlens[rows], ms[rows],
            idx)


def maybe_mesh_rows(haps, reads, rlens, ms, k_idx: int, H: int, R: int,
                    scorer: str, hap_index=None,
                    devices: Optional[Sequence[torch.device]] = None,
                    width: int = ROW_GROUP) -> Optional[torch.Tensor]:
    """Splits one fused_batch call's rows over `devices` (default:
    mesh_devices of the rows' device) and returns the packed rows on the
    rows' device, in row order; None when one device (or VAPOR_MESH=0,
    or too few rows) makes the one-device launch the right path.

    Rows are padded to a dp x width multiple with rows that hold no
    eligible cell (HAP_PAD haps, READ_PAD reads, rlen 1, m 0); dp is
    capped by the row count so that small batches do not pay for pad
    rows.  Each part runs fused_batch's one-device launch on its own
    device and, on a card, its own stream, so parts on one card overlap
    too.  A part that fails raises."""
    from ..engine.fused import fused_batch_local
    home = reads.device
    if devices is None:
        devices = mesh_devices(home)
    B = reads.shape[0]
    dp = min(len(devices), -(-B // width))
    if dp <= 1:
        return None
    grid = make_mesh(dp, devices=devices)
    per = -(-B // (dp * width)) * width
    pad = dp * per - B
    if pad:
        if hap_index is not None:     # pad rows -> one all-HAP_PAD row
            hap_index = _grow(hap_index, pad, haps.shape[0])
            haps = _grow(haps, 1, HAP_PAD)
        else:
            haps = _grow(haps, pad, HAP_PAD)
        reads, rlens, ms = _grow(reads, pad, READ_PAD), \
            _grow(rlens, pad, 1), _grow(ms, pad, 0)
    here = torch.cuda.current_stream(home) if home.type == "cuda" else None
    launched = []
    for p, (dev, *_) in enumerate(grid):
        part = list(_part(haps, reads, rlens, ms, hap_index,
                          slice(p * per, (p + 1) * per)))
        if dev.type != "cuda":
            part = [None if x is None else x.to(dev) for x in part]
            launched.append((fused_batch_local(
                *part[:4], k_idx, scorer, part[4])[2], None))
            continue
        stream = _STREAMS.get((dev, p))
        if stream is None:
            stream = _STREAMS.setdefault((dev, p), torch.cuda.Stream(dev))
        if here is not None:
            stream.wait_stream(here)
        with torch.cuda.stream(stream):
            for x in part:
                if x is not None and x.is_cuda:
                    x.record_stream(stream)
            part = [None if x is None else x.to(dev, non_blocking=True)
                    for x in part]
            launched.append((fused_batch_local(
                *part[:4], k_idx, scorer, part[4])[2], stream))
    outs = []
    for out, stream in launched:
        if stream is not None:
            with torch.cuda.stream(stream):
                out = out.to(home, non_blocking=True)
            if here is not None:
                here.wait_stream(stream)
                out.record_stream(here)
            else:
                stream.synchronize()
        outs.append(out.to(home))
    return torch.cat(outs)[:B]
