"""The six dot-plot kernels, their wrappers and their plain versions.

Every kernel takes one batch of (read, haplotype) rows in packed k-mer
codes (engine/fused.py builds them):

* ``ch`` (B, lanes, H) int32 hap codes, ``cf`` (B, lanes, R) int32
  forward read codes, ``cd`` (B, lanes, R) int32 reverse-strand codes
  already in dot-space columns (``rc_dot_codes``);
* ``ms`` and ``rlens`` (B,) int32: the read's missing prefix and length;
* ``k`` in {10, 20, 30, 40}, with lanes = ceil(k / 8).

A cell (i, j) is eligible when i >= m and j <= rlen - k; it holds a
forward hit when ch[:, i] == cf[:, j] and a reverse hit when
ch[:, i] == cd[:, j], and its multiplicity is the number of strands that
hit (0..2).  Keep tables are (B, W) bool over the bins j - i + H
(``keep_d``) and j + i (``keep_a``), W = hist_width(H, R).

Each wrapper launches its CUDA kernel for CUDA tensors and counts the
launch in ``LAUNCHES``, and by (name, route, H, R) in ``LAUNCH_SHAPES``
(``ROUTES``: route "score", or "selfstats" for ``hist_self``, the window
refiner's rows through hist's self-stats entry point); for CPU tensors it
runs the plain PyTorch version of the same function, which lives here
too.  Plain versions run on any device; ``PLAIN_CUDA_CALLS`` counts the
calls they get with CUDA tensors, which only the on-card comparison of a
kernel with its plain version makes.  Every C entry point zeroes its
kernel's outputs itself (one cudaMemsetAsync on the launch's stream), so
the wrappers allocate them with ``torch.empty`` and run no fill.
"""
from __future__ import annotations

import functools
from collections import Counter
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..constants import hist_width
from . import build

NAMES = ("hist", "left_hist", "kept_hist", "moment", "moment2", "rdd_moment")
# (kernel, route) -> the wrapper that launches it
ROUTES = {**{(name, "score"): name for name in NAMES},
          ("hist", "selfstats"): "hist_self"}
LAUNCHES: Dict[str, int] = dict.fromkeys(NAMES, 0)
LAUNCH_SHAPES: Counter = Counter()
PLAIN_CUDA_CALLS: Dict[str, int] = dict.fromkeys(NAMES, 0)


def reset_counts() -> None:
    for name in NAMES:
        LAUNCHES[name] = 0
        PLAIN_CUDA_CALLS[name] = 0
    LAUNCH_SHAPES.clear()


# ---------------------------------------------------------------------------
# argument checks and launch
# ---------------------------------------------------------------------------

_LANES = {10: 2, 20: 3, 30: 4, 40: 5}      # k -> code lanes, ceil(k / 8)


def _check(ch, cf, cd, ms, rlens, k: int,
           tables: Sequence[torch.Tensor] = (),
           z: Optional[torch.Tensor] = None) -> Tuple[int, int, int, int]:
    """Validates one batch (and the per-row intercepts z, where given);
    returns (B, lanes, H, R)."""
    lanes = _LANES.get(k)
    if lanes is None:
        raise ValueError(f"k must be 10, 20, 30 or 40, got {k}")
    if ch.dim() != 3:
        raise ValueError(f"ch must be (B, lanes, H), got {tuple(ch.shape)}")
    B, got, H = ch.shape
    R = cf.shape[-1]
    if got != lanes:
        raise ValueError(f"k={k} needs {lanes} code lanes, got {got}")
    device = ch.device
    want = [("ch", ch, torch.int32, (B, lanes, H)),
            ("cf", cf, torch.int32, (B, lanes, R)),
            ("cd", cd, torch.int32, (B, lanes, R)),
            ("ms", ms, torch.int32, (B,)),
            ("rlens", rlens, torch.int32, (B,))]
    if tables:
        W = hist_width(H, R)
        want += [(f"table{n}", t, torch.bool, (B, W))
                 for n, t in enumerate(tables)]
    if z is not None:
        want.append(("z", z, torch.int32, (B,)))
    for name, t, dtype, shape in want:
        if t.dtype != dtype or t.shape != shape:
            raise ValueError(f"{name}: want {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, ch on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return B, lanes, H, R


# (kernel, route) -> its C entry point, once bound
_ENTRY: Dict[Tuple[str, str], object] = {}


def _launch(name: str, ch: torch.Tensor, *args,
            route: str = "score") -> None:
    """Launches the kernel's route on ch's card, on the current stream:
    the C entry point gets ch, then args = (cf, cd, ms, rlens, B, H, R,
    ...), tensors as their data pointers."""
    fn = _ENTRY.get((name, route))
    if fn is None:
        fn = _ENTRY[name, route] = build.entry_point(name, route)
    index = ch.get_device()
    # the raw stream handle, as torch.cuda.current_stream(index)
    # .cuda_stream gives it, without building a Stream object
    err = fn(ch.data_ptr(),
             *[a.data_ptr() if isinstance(a, torch.Tensor) else a
               for a in args],
             index, torch._C._cuda_getCurrentRawStream(index))
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    LAUNCH_SHAPES[name, route, args[5], args[6]] += 1


def _plain(ch: torch.Tensor) -> bool:
    """Whether a wrapper runs its plain version: for CPU tensors only; a
    CUDA tensor launches the kernel or raises."""
    return ch.device.type == "cpu"


def _note_plain(name: str, t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        PLAIN_CUDA_CALLS[name] += 1


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _row_hits(ch, cf, cd, m: int, rlen: int, k: int):
    """Hit cells of one row: (i, j, forward 0/1, reverse 0/1), row-major."""
    H, R = ch.shape[1], cf.shape[1]
    fw = ch[0, :, None] == cf[0, None, :]
    rc = ch[0, :, None] == cd[0, None, :]
    for lane in range(1, ch.shape[0]):
        fw &= ch[lane, :, None] == cf[lane, None, :]
        rc &= ch[lane, :, None] == cd[lane, None, :]
    ok = (torch.arange(H, device=ch.device) >= m)[:, None] & \
        (torch.arange(R, device=ch.device) <= rlen - k)[None, :]
    fw &= ok
    rc &= ok
    i, j = torch.nonzero(fw | rc, as_tuple=True)
    return i, j, fw[i, j].long(), rc[i, j].long()


def _rows(ch, cf, cd, ms, rlens, k):
    for b, (m, rlen) in enumerate(zip(ms.tolist(), rlens.tolist())):
        yield b, _row_hits(ch[b], cf[b], cd[b], m, rlen, k)


def hist_plain(ch, cf, cd, ms, rlens, k: int):
    _note_plain("hist", ch)
    B, _, H = ch.shape
    W = hist_width(H, cf.shape[-1])
    h_d = torch.zeros((B, W), dtype=torch.int32, device=ch.device)
    h_a = torch.zeros_like(h_d)
    scal = torch.zeros((B, 4), dtype=torch.int32, device=ch.device)
    for b, (i, j, f, r) in _rows(ch, cf, cd, ms, rlens, k):
        mult = (f + r).int()
        h_d[b].index_add_(0, j - i + H, mult)
        h_a[b].index_add_(0, j + i, mult)
        if i.numel():
            scal[b] = torch.stack([f.sum(), r.sum(), i.min() - (H + 1),
                                   i.max() + 1])
    return h_d, h_a, scal


def hist_self_plain(ch, cf, cd, ms, rlens, k: int):
    _note_plain("hist", ch)
    out = torch.zeros((ch.shape[0], 3), dtype=torch.int64, device=ch.device)
    for b, (i, j, f, r) in _rows(ch, cf, cd, ms, rlens, k):
        mult = f + r
        out[b] = torch.stack([mult.sum(), mult[j == i].sum(),
                              mult[j < i].sum()])
    return out


def left_hist_plain(ch, cf, cd, ms, rlens, k: int, keep_d):
    _note_plain("left_hist", ch)
    B, _, H = ch.shape
    h_a = torch.zeros(keep_d.shape, dtype=torch.int32, device=ch.device)
    for b, (i, j, f, r) in _rows(ch, cf, cd, ms, rlens, k):
        left = ~keep_d[b][j - i + H]
        h_a[b].index_add_(0, (j + i)[left], (f + r)[left].int())
    return h_a


def kept_hist_plain(ch, cf, cd, ms, rlens, k: int, keep_d, keep_a):
    _note_plain("kept_hist", ch)
    B, _, H = ch.shape
    h_d = torch.zeros(keep_d.shape, dtype=torch.int32, device=ch.device)
    for b, (i, j, f, r) in _rows(ch, cf, cd, ms, rlens, k):
        d_bin = j - i + H
        kept = keep_d[b][d_bin] | keep_a[b][j + i]
        h_d[b].index_add_(0, d_bin[kept], (f + r)[kept].int())
    return h_d


def _moments(i, j, mult, m: int, kept, want_w10: bool):
    """[count, sum |d|, within-10% count] over kept hit cells."""
    mult = mult[kept]
    ip = i[kept] - m
    ad = (j[kept] - ip).abs()
    w10 = mult[(ip > 0) & (25 * ad < 4 * ip)].sum() if want_w10 \
        else mult.new_zeros(())
    return torch.stack([mult.sum(), (mult * ad).sum(), w10])


def moment_plain(ch, cf, cd, ms, rlens, k: int, keep_d, keep_a,
                 want_w10: bool):
    _note_plain("moment", ch)
    B, _, H = ch.shape
    mom = torch.zeros((B, 3), dtype=torch.int64, device=ch.device)
    for b, (i, j, f, r) in _rows(ch, cf, cd, ms, rlens, k):
        kept = keep_d[b][j - i + H] | keep_a[b][j + i]
        mom[b] = _moments(i, j, f + r, int(ms[b]), kept, want_w10)
    return mom


def moment2_plain(ch, cf, cd, ms, rlens, k: int, keep_d1, keep_a1,
                  keep_d2, keep_a2):
    _note_plain("moment2", ch)
    B, _, H = ch.shape
    mom = torch.zeros((B, 6), dtype=torch.int64, device=ch.device)
    for b, (i, j, f, r) in _rows(ch, cf, cd, ms, rlens, k):
        d_bin, a_bin, m = j - i + H, j + i, int(ms[b])
        kept1 = keep_d1[b][d_bin] | keep_a1[b][a_bin]
        kept2 = keep_d2[b][d_bin] | keep_a2[b][a_bin]
        mom[b, :3] = _moments(i, j, f + r, m, kept1, False)
        mom[b, 3:] = _moments(i, j, f + r, m, kept2, True)
    return mom


def rdd_moment_plain(ch, cf, cd, ms, rlens, k: int, keep_d, keep_a, z):
    _note_plain("rdd_moment", ch)
    B, _, H = ch.shape
    mom = torch.zeros((B, 6), dtype=torch.int64, device=ch.device)
    for b, (i, j, f, r) in _rows(ch, cf, cd, ms, rlens, k):
        kept = keep_d[b][j - i + H] | keep_a[b][j + i]
        m, zb = int(ms[b]), int(z[b])
        mom[b, :3] = _moments(i, j, f + r, m, kept, False)
        mult = (f + r)[kept]
        ip = i[kept] - m
        val = zb - 2 * (j[kept] - ip)
        den = (2 * ip + zb).abs()
        den = torch.where(2 * ip + zb == 0, (2 * ip + zb + 2).abs(), den)
        sel = mult * (10 * val.abs() > den)
        mom[b, 3:] = torch.stack([sel.sum(), (sel * val.clamp(min=0)).sum(),
                                  (sel * (-val).clamp(min=0)).sum()])
    return mom


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def hist(ch, cf, cd, ms, rlens, k: int):
    """-> h_d (B, W) int32 over j - i + H, h_a (B, W) int32 over j + i,
    each summing hit multiplicity, and scal (B, 4) int32 = [forward hits,
    reverse hits, first hit row - (H + 1), last hit row + 1], all 0 where
    a row has no hit (hist_scal decodes it): views of one buffer, which
    the C entry point zeroes."""
    B, lanes, H, R = _check(ch, cf, cd, ms, rlens, k)
    if _plain(ch):
        return hist_plain(ch, cf, cd, ms, rlens, k)
    W = hist_width(H, R)
    out = torch.empty((2 * W + 4) * B, dtype=torch.int32, device=ch.device)
    _launch("hist", ch, cf, cd, ms, rlens, B, H, R, lanes, k, W, out)
    return (out.as_strided((B, W), (W, 1)),
            out.as_strided((B, W), (W, 1), B * W),
            out.as_strided((B, 4), (4, 1), 2 * B * W))


@functools.lru_cache(maxsize=None)
def _scal_offset(H: int, device: torch.device) -> torch.Tensor:
    return torch.tensor([0, 0, H + 1, -1], dtype=torch.int64, device=device)


def hist_scal(scal: torch.Tensor, H: int) -> torch.Tensor:
    """hist's (B, 4) scal -> (B, 4) int64 [forward hits, reverse hits,
    first hit row (H + 1 if none), last hit row (-1 if none)], in one
    add (the widening to int64 the caller would make anyway)."""
    return scal + _scal_offset(H, scal.device)


def hist_self(ch, cf, cd, ms, rlens, k: int):
    """hist's self-stats route, for rows whose read is their own hap (the
    window refiner's): -> (B, 3) int64 [total, diag, below], the hit
    multiplicity summed over every cell, over j == i and over j < i: the
    sum of hist's h_d row, its bin H and its bins below H."""
    B, lanes, H, R = _check(ch, cf, cd, ms, rlens, k)
    if _plain(ch):
        return hist_self_plain(ch, cf, cd, ms, rlens, k)
    out = torch.empty((B, 3), dtype=torch.int64, device=ch.device)
    _launch("hist", ch, cf, cd, ms, rlens, B, H, R, lanes, k, out,
            route="selfstats")
    return out


def left_hist(ch, cf, cd, ms, rlens, k: int, keep_d):
    """-> (B, W) int32 histogram over j + i of the hit multiplicity of
    cells whose bin j - i + H is not set in keep_d.  The C entry point
    zeroes it."""
    B, lanes, H, R = _check(ch, cf, cd, ms, rlens, k, (keep_d,))
    if _plain(ch):
        return left_hist_plain(ch, cf, cd, ms, rlens, k, keep_d)
    W = hist_width(H, R)
    h_a = torch.empty((B, W), dtype=torch.int32, device=ch.device)
    _launch("left_hist", ch, cf, cd, ms, rlens, B, H, R, lanes,
            k, W, keep_d, h_a)
    return h_a


def kept_hist(ch, cf, cd, ms, rlens, k: int, keep_d, keep_a):
    """-> (B, W) int32 histogram over j - i + H of the hit multiplicity of
    cells kept by keep_d | keep_a: the intercept fit's input.  The C
    entry point zeroes it."""
    B, lanes, H, R = _check(ch, cf, cd, ms, rlens, k, (keep_d, keep_a))
    if _plain(ch):
        return kept_hist_plain(ch, cf, cd, ms, rlens, k, keep_d, keep_a)
    W = hist_width(H, R)
    h_d = torch.empty((B, W), dtype=torch.int32, device=ch.device)
    _launch("kept_hist", ch, cf, cd, ms, rlens, B, H, R, lanes,
            k, W, keep_d, keep_a, h_d)
    return h_d


def moment(ch, cf, cd, ms, rlens, k: int, keep_d, keep_a,
           want_w10: bool):
    """-> (B, 3) int64 [count, sum |d|, within-10% count (0 unless
    want_w10)] over cells kept by keep_d | keep_a, d = j - (i - m).  The
    C entry point zeroes mom."""
    B, lanes, H, R = _check(ch, cf, cd, ms, rlens, k, (keep_d, keep_a))
    if _plain(ch):
        return moment_plain(ch, cf, cd, ms, rlens, k, keep_d, keep_a,
                            want_w10)
    mom = torch.empty((B, 3), dtype=torch.int64, device=ch.device)
    _launch("moment", ch, cf, cd, ms, rlens, B, H, R, lanes, k,
            hist_width(H, R), keep_d, keep_a, int(want_w10), mom)
    return mom


def moment2(ch, cf, cd, ms, rlens, k: int, keep_d1, keep_a1, keep_d2,
            keep_a2):
    """-> (B, 6) int64: moment(keep_d1, keep_a1, want_w10=False) beside
    moment(keep_d2, keep_a2, want_w10=True), in one pass.  The C entry
    point zeroes mom."""
    B, lanes, H, R = _check(ch, cf, cd, ms, rlens, k,
                            (keep_d1, keep_a1, keep_d2, keep_a2))
    if _plain(ch):
        return moment2_plain(ch, cf, cd, ms, rlens, k, keep_d1, keep_a1,
                             keep_d2, keep_a2)
    mom = torch.empty((B, 6), dtype=torch.int64, device=ch.device)
    _launch("moment2", ch, cf, cd, ms, rlens, B, H, R, lanes,
            k, hist_width(H, R), keep_d1, keep_a1, keep_d2, keep_a2, mom)
    return mom


def rdd_moment(ch, cf, cd, ms, rlens, k: int, keep_d, keep_a, z):
    """-> (B, 6) int64 [count, sum |d|, 0, sel count, sel pos, sel neg]
    over cells kept by keep_d | keep_a, with d = j - (i - m) and the
    row's intercept z (B,) int32: a kept cell is selected when
    10 |z - 2d| > den, den = |2(i - m) + z| (|2(i - m) + z + 2| where
    that is 0); sel pos and sel neg sum the positive and negative parts
    of z - 2d over the selected cells.  Every sum is weighted by the
    cell's hit multiplicity.  The C entry point zeroes mom."""
    B, lanes, H, R = _check(ch, cf, cd, ms, rlens, k, (keep_d, keep_a), z)
    if _plain(ch):
        return rdd_moment_plain(ch, cf, cd, ms, rlens, k, keep_d, keep_a, z)
    mom = torch.empty((B, 6), dtype=torch.int64, device=ch.device)
    _launch("rdd_moment", ch, cf, cd, ms, rlens, B, H, R, lanes,
            k, hist_width(H, R), keep_d, keep_a, z, mom)
    return mom
