"""The engine's nine kernels (six dot-plot kernels, three glue kernels),
their wrappers and their plain versions.

Every dot-plot kernel takes one batch of (read, haplotype) rows in
packed k-mer codes (the row_codes kernel builds them):

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
dot-plot kernel's outputs itself (one cudaMemsetAsync on the launch's
stream), so the wrappers allocate them with ``torch.empty`` and run no
fill.

Three more kernels (``GLUE_NAMES``) compute what the JAX engine's
compiled program fuses between those passes, so that no torch-op
sequence of the engine runs on the card:

* ``row_codes``: the code arrays (ch, cf, cd) from the hap, read and
  length rows (csrc/codes.cu);
* ``kept_tables``: the gap-clustered keep tables of up to four
  histograms in one launch (csrc/kept_table.cu);
* ``intercept_z``: each row's intercept from its kept d-histogram
  (csrc/intercept.cu).

They count like the six, their launches keyed (name, "glue", H, R) by
the batch's (H, R), and their plain versions are the torch-op sequences
the engine ran before them.  Every output word of theirs is written by
the kernel, so they need no zeroing either.
"""
from __future__ import annotations

import functools
from collections import Counter
from typing import Dict, Optional, Sequence, Tuple

import torch

from .. import oracle
from ..constants import HAP_PAD, NIB_LUT, READ_PAD, hist_width
from ...utils import trace
from . import build

# the six dot-plot kernels
NAMES = ("hist", "left_hist", "kept_hist", "moment", "moment2", "rdd_moment")
# (kernel, route) -> the wrapper that launches it
ROUTES = {**{(name, "score"): name for name in NAMES},
          ("hist", "selfstats"): "hist_self"}
# the three kernels of the engine's glue; each is its own wrapper
GLUE_NAMES = ("row_codes", "kept_tables", "intercept_z")
ALL_NAMES = NAMES + GLUE_NAMES
LAUNCHES: Dict[str, int] = dict.fromkeys(ALL_NAMES, 0)
LAUNCH_SHAPES: Counter = Counter()
PLAIN_CUDA_CALLS: Dict[str, int] = dict.fromkeys(ALL_NAMES, 0)


def reset_counts() -> None:
    for name in ALL_NAMES:
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
    _validate(want)
    return B, lanes, H, R


def _validate(want, prefix: str = "") -> torch.device:
    """Raises unless each (label, tensor, dtype, shape) of `want` has its
    dtype and shape, lies on the first one's device and is contiguous,
    and that device is the CPU or a card; returns the device."""
    first, device = want[0][0], want[0][1].device
    for label, t, dtype, shape in want:
        if t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{prefix}{label}: want {dtype} "
                             f"{tuple(shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{prefix}{label} is on {t.device}, {first} "
                             f"on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{prefix}{label} must be contiguous")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device


# (kernel, route) -> its C entry point, once bound
_ENTRY: Dict[Tuple[str, str], object] = {}


def _launch(name: str, ch: torch.Tensor, *args,
            route: str = "score") -> None:
    """Launches the kernel's route on ch's card, on the current stream:
    the C entry point gets ch, then args = (cf, cd, ms, rlens, B, H, R,
    ...), tensors as their data pointers."""
    fn = _ENTRY.get((name, route))
    bound = fn is None
    if bound:
        fn = _ENTRY[name, route] = build.entry_point(name, route)
        _first_reading(ROUTES[name, route], "enter")
    index = ch.get_device()
    # the raw stream handle, as torch.cuda.current_stream(index)
    # .cuda_stream gives it, without building a Stream object
    err = fn(ch.data_ptr(),
             *[a.data_ptr() if isinstance(a, torch.Tensor) else a
               for a in args],
             index, torch._C._cuda_getCurrentRawStream(index))
    if bound:
        _first_reading(ROUTES[name, route], "exit")
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    LAUNCH_SHAPES[name, route, args[5], args[6]] += 1


def _launch_glue(name: str, shape: Tuple[int, int], first: torch.Tensor,
                 *args) -> None:
    """Launches a glue kernel on first's card, on the current stream: its
    C entry point gets first, then args, tensors as their data pointers
    (None as a null pointer).  The launch counts under (name, "glue",
    *shape)."""
    fn = _ENTRY.get((name, "glue"))
    bound = fn is None
    if bound:
        fn = _ENTRY[name, "glue"] = build.entry_point(name, "glue")
        _first_reading(name, "enter")
    index = first.get_device()
    err = fn(first.data_ptr(),
             *[a.data_ptr() if isinstance(a, torch.Tensor) else a
               for a in args],
             index, torch._C._cuda_getCurrentRawStream(index))
    if bound:
        _first_reading(name, "exit")
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    LAUNCH_SHAPES[(name, "glue", *shape)] += 1


def _first_reading(wrapper: str, edge: str) -> None:
    """The memory reading at entry to or exit from the first call of a C
    entry point in this process, where its library loads its module."""
    trace.memory(f"kernel.first.{wrapper}.{edge}", once=True)


def _glue_shape(W: int, H: int, R: int) -> Tuple[int, int]:
    """The (H, R) a histogram launch counts under: the batch's, checked
    against the histograms' width W."""
    if hist_width(H, R) != W:
        raise ValueError(f"histograms of width {W} are not those of "
                         f"H={H}, R={R} (width {hist_width(H, R)})")
    return int(H), int(R)


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


# ---------------------------------------------------------------------------
# the glue kernels: plain versions
# ---------------------------------------------------------------------------

def pack_codes(seqs: torch.Tensor, k: int, pad_byte: int) -> torch.Tensor:
    """(B, L) uint8 -> (B, lanes, L) int32 rolling packed k-mer codes.

    Lane l packs window symbols [8l, min(8l + 8, k)), 4 bits each;
    positions whose window runs past the end pack the pad's symbol."""
    B, L = seqs.shape
    lanes = -(-k // 8)
    lut = torch.as_tensor(NIB_LUT, device=seqs.device)
    ext = torch.cat([lut[seqs.long()],
                     torch.full((B, 8 * lanes), int(NIB_LUT[pad_byte]),
                                dtype=torch.int64, device=seqs.device)], 1)
    out = []
    for lane in range(lanes):
        acc = torch.zeros((B, L), dtype=torch.int64, device=seqs.device)
        for t in range(min(8, k - 8 * lane)):
            s = 8 * lane + t
            acc |= ext[:, s:s + L] << (4 * t)
        # the 32 bits as a signed int32 (only equality is ever asked)
        out.append(torch.where(acc >= 2 ** 31, acc - 2 ** 32, acc))
    return torch.stack(out, 1).to(torch.int32)


def derive_rc_rows(reads: torch.Tensor, rlens: torch.Tensor
                   ) -> torch.Tensor:
    """(B, R) forward codes -> (B, R) reverse-complement codes followed by
    a READ_PAD tail: the host's encode_comp(seq)[::-1] + pad, byte for
    byte (oracle.encode_comp is a code-level LUT)."""
    B, R = reads.shape
    comp = torch.as_tensor(oracle._COMP_LUT, device=reads.device)[
        reads.long()]
    ext = torch.cat([comp.flip(1), torch.full_like(comp, READ_PAD)], 1)
    idx = (R - rlens.long())[:, None] + torch.arange(R, device=reads.device)
    return ext.gather(1, idx)


def rc_dot_codes(rc: torch.Tensor, rlens: torch.Tensor, k: int
                 ) -> torch.Tensor:
    """(B, R) rc rows -> (B, lanes, R) codes D with D[:, :, j] the packed
    rc k-mer at q = rlen - k - j, i.e. indexed by the dot-space column j.

    With rev[p] = crc[R-1-p], crc[rlen-k-j] = rev[(R-1+k-rlen) + j].
    Holds for rc rows laid out as codes then a READ_PAD tail (what
    derive_rc_rows makes); columns j > rlen - k carry garbage and are
    outside every kernel's eligible cells."""
    B, R = rc.shape
    rev = pack_codes(rc, k, READ_PAD).flip(2)
    ext = torch.cat([rev, rev], 2)
    off = ((R - 1 + k) - rlens.long()).clamp(0, R)
    idx = off[:, None] + torch.arange(R, device=rc.device)
    return ext.gather(2, idx[:, None, :].expand(-1, ext.shape[1], -1))


def row_codes_plain(haps, reads, rlens, k: int, hap_index=None):
    _note_plain("row_codes", reads)
    ch = pack_codes(haps, k, HAP_PAD)
    if hap_index is not None:
        ch = ch.index_select(0, hap_index)
    return (ch, pack_codes(reads, k, READ_PAD),
            rc_dot_codes(derive_rc_rows(reads, rlens), rlens, k))


def _cummin(x: torch.Tensor) -> torch.Tensor:
    return -torch.cummax(-x, 1).values


def kept_table_plain(h: torch.Tensor, gap: int, thr: int,
                     fallback_max: bool) -> torch.Tensor:
    """One keep table (pyx:551-580 semantics): clusters of present values
    (a gap < `gap` merges) are kept when their weighted total exceeds
    thr, else, with the fallback, when the total equals the maximum."""
    B, W = h.shape
    h = h.long()
    idx = torch.arange(W, device=h.device).expand(B, W)
    nz = h > 0
    prev_nz = torch.cummax(torch.where(nz, idx, -1), 1).values
    prev_excl = torch.cat([torch.full_like(prev_nz[:, :1], -1),
                           prev_nz[:, :-1]], 1)
    is_start = nz & ((idx - prev_excl >= gap) | (prev_excl < 0))
    cum = torch.cumsum(h, 1)
    cum_excl = torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], 1)
    cum_before = torch.cummax(torch.where(is_start, cum_excl, -1), 1).values
    running = cum - cum_before
    # a segment ends one before the next start, or at the last bin
    nxt = _cummin(torch.where(is_start, idx, W + 1).flip(1)).flip(1)
    nxt_excl = torch.cat([nxt[:, 1:], torch.full_like(nxt[:, :1], W + 1)],
                         1)
    seg_end = (nxt_excl - 1).clamp(max=W - 1)
    seg_total = running.gather(1, seg_end)
    over = nz & (seg_total > thr)
    if not fallback_max:
        return over
    # segment representatives are the start bins (an end bin can be a
    # trailing zero when the segment runs to the boundary)
    max_total = torch.where(is_start, seg_total, 0).amax(1, keepdim=True)
    fallback = nz & (seg_total == max_total)
    return torch.where(over.any(1, keepdim=True), over, fallback)


def kept_tables_plain(hs, specs, H: int, R: int, gap: int = 10):
    _note_plain("kept_tables", hs[0])
    return tuple(kept_table_plain(h, gap, thr, fallback)
                 for h, (thr, fallback) in zip(hs, specs))


_FAR = 2 ** 30      # stands for "no value" in the min/max scans


def _bins(v, lo, hi):
    """Bin index 0..10 of each value: the number of t in 1..10 with
    10 (v - lo) >= t (hi - lo).  (The shape comes from the broadcast
    itself: torch.broadcast_shapes imports sympy at its first call,
    seconds of every new process.)"""
    d, span = 10 * (v - lo), hi - lo
    b = torch.zeros_like(d)
    for t in range(1, 11):
        b += d >= t * span
    return b


def intercept_z_plain(h: torch.Tensor, H: int, R: int):
    _note_plain("intercept_z", h)
    B, W = h.shape
    h = h.long()
    v = (torch.arange(W, device=h.device) - H).expand(B, W)
    nz = h > 0
    lo = torch.where(nz, v, _FAR).amin(1, keepdim=True)
    hi = torch.where(nz, v, -_FAR).amax(1, keepdim=True)
    hz = torch.where(nz, h, 0)
    b1 = _bins(v, lo, hi)
    counts1 = torch.zeros((B, 11), dtype=torch.int64,
                          device=h.device).scatter_add_(1, b1, hz)
    win1 = counts1 == counts1.amax(1, keepdim=True)
    # every first-level bin t at once: (B, 11, W)
    in_bin = nz[:, None, :] & (b1[:, None, :] ==
                               torch.arange(11, device=h.device)[:, None])
    vv = v[:, None, :]
    s_lo = torch.where(in_bin, vv, _FAR).amin(2, keepdim=True)
    s_hi = torch.where(in_bin, vv, -_FAR).amax(2, keepdim=True)
    b2 = _bins(vv, s_lo, s_hi)
    h_in = torch.where(in_bin, h[:, None, :], 0)
    counts2 = torch.zeros((B, 11, 11), dtype=torch.int64,
                          device=h.device).scatter_add_(2, b2, h_in)
    top2 = counts2 == counts2.amax(2, keepdim=True)
    n_win2 = top2.sum(2)
    wb = top2.int().argmax(2, keepdim=True)      # first winning sub-bin
    hsel = torch.where(b2 == wb, h_in, 0)
    n = hsel.sum(2, keepdim=True)
    cums = hsel.cumsum(2)
    v1 = torch.where(cums >= (n - 1) // 2 + 1, vv, _FAR).amin(2)
    v2 = torch.where(cums >= n // 2 + 1, vv, _FAR).amin(2)
    n_wins = torch.where(win1, n_win2, 0)
    pick = (n_wins > 0).int().argmax(1, keepdim=True)
    found = (h.sum(1) > 0) & (n_wins.sum(1) == 1)
    z = torch.where(found, (v1 + v2).gather(1, pick)[:, 0], 0)
    return found, z


# ---------------------------------------------------------------------------
# the glue kernels: wrappers
# ---------------------------------------------------------------------------

def row_codes(haps, reads, rlens, k: int, hap_index=None):
    """(U, H) uint8 haps, (B, R) uint8 forward reads (a READ_PAD tail
    past each length) and (B,) int32 rlens in [0, R] -> the kernels'
    code arrays (ch, cf, cd), int32: ch (U, lanes, H), or (B, lanes, H)
    with hap_index (B,) int64, row b then packing haps[hap_index[b]]
    (indices in [0, U)); cf and cd (B, lanes, R), cd the reverse strand
    in dot-space columns (rc_dot_codes), every column as the plain
    version lays it out.  An index or length outside its range raises on
    the CPU (the plain version's index_select and gather) and stops the
    kernel with a device-side assert on the card, as those torch ops do
    there."""
    lanes = _LANES.get(k)
    if lanes is None:
        raise ValueError(f"k must be 10, 20, 30 or 40, got {k}")
    if haps.dim() != 2 or reads.dim() != 2:
        raise ValueError(f"row_codes: want (U, H) haps and (B, R) reads, "
                         f"got {tuple(haps.shape)} and "
                         f"{tuple(reads.shape)}")
    (U, H), (B, R) = haps.shape, reads.shape
    want = [("reads", reads, torch.uint8, (B, R)),
            ("haps", haps, torch.uint8, (U, H)),
            ("rlens", rlens, torch.int32, (B,))]
    if hap_index is not None:
        want.append(("hap_index", hap_index, torch.int64, (B,)))
    _validate(want, "row_codes: ")
    if _plain(reads):
        return row_codes_plain(haps, reads, rlens, k, hap_index)
    Bh = U if hap_index is None else B
    ch = torch.empty((Bh, lanes, H), dtype=torch.int32, device=reads.device)
    cf = torch.empty((B, lanes, R), dtype=torch.int32, device=reads.device)
    cd = torch.empty_like(cf)
    _launch_glue("row_codes", (H, R), haps, reads, rlens, hap_index, U, B,
                 H, R, lanes, k, ch, cf, cd)
    return ch, cf, cd


MAX_TABLES = 4              # keep tables one kept_tables launch computes
_SMEM_BYTES = 227 * 1024    # the dynamic shared memory a block may take


def kept_tables(hs, specs, H: int, R: int, gap: int = 10):
    """Keep tables of up to MAX_TABLES (B, W) int32 histograms (no
    negative bin) in one launch: table t clusters hs[t]'s present bins
    (a gap < `gap` merges) and keeps a cluster whose total exceeds
    specs[t] = (thr, fallback_max)'s thr, else, with fallback_max, one
    whose total equals the row's largest.  -> a tuple of (B, W) bool
    tables, views of one buffer.  (H, R) is the batch's, whose histogram
    width W must be, and which the launch counts under."""
    if not 1 <= len(hs) <= MAX_TABLES or len(specs) != len(hs):
        raise ValueError(f"kept_tables: want 1 to {MAX_TABLES} histograms "
                         f"and one (thr, fallback_max) each, got {len(hs)} "
                         f"and {len(specs)}")
    if hs[0].dim() != 2:
        raise ValueError(f"kept_tables: want (B, W) histograms, got "
                         f"{tuple(hs[0].shape)}")
    B, W = hs[0].shape
    device = _validate([(f"hist{t}", h, torch.int32, (B, W))
                        for t, h in enumerate(hs)], "kept_tables: ")
    if gap < 1 or ((W - 1) // gap + 1) * 8 > _SMEM_BYTES:
        raise ValueError(f"kept_tables: gap {gap} at width {W} is outside "
                         f"what one block's cluster totals hold")
    key = _glue_shape(W, H, R)
    if _plain(hs[0]):
        return kept_tables_plain(hs, specs, H, R, gap)
    n = len(hs)
    out = torch.empty((n, B, W), dtype=torch.bool, device=device)
    ptrs = list(hs) + [None] * (MAX_TABLES - n)
    thrs = [int(thr) for thr, _ in specs] + [0] * (MAX_TABLES - n)
    fallback = sum(1 << t for t, (_, fb) in enumerate(specs) if fb)
    _launch_glue("kept_tables", key, out, *ptrs, *thrs, fallback, n, B, W,
                 gap)
    return tuple(out[t] for t in range(n))


def intercept_z(h, H: int, R: int):
    """(B, W) int32 d-histograms over bins j - i + H -> (found (B,) bool,
    z (B,) int64), z twice the re-centering intercept of each row.

    Two levels of 11 bins and a weighted median, in exact integers: the
    values v = bin - H with a count are binned between their min and max;
    each bin of the largest total is binned again between its own min and
    max; z is v1 + v2, the values at ranks (n - 1) // 2 + 1 and n // 2 + 1
    of the sub-bin of the largest total.  A row finds an intercept only
    when its sum is positive and exactly one sub-bin wins over all
    winning bins; otherwise z is 0.  Stays on the tensors' device (no
    host sync).  (H, R) is the batch's, whose histogram width W must be,
    and which the launch counts under."""
    if h.dim() != 2:
        raise ValueError(f"intercept_z: want (B, W) histograms, got "
                         f"{tuple(h.shape)}")
    B, W = h.shape
    device = _validate([("hist", h, torch.int32, (B, W))], "intercept_z: ")
    key = _glue_shape(W, H, R)
    if _plain(h):
        return intercept_z_plain(h, H, R)
    out = torch.empty(9 * B, dtype=torch.uint8, device=device)
    z = out[:8 * B].view(torch.int64)
    found = out[8 * B:].view(torch.bool)
    _launch_glue("intercept_z", key, h, B, W, H, z, found)
    return found, z
