"""The four dot-plot kernels, their wrappers and their plain versions.

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
launch in ``LAUNCHES``; for CPU tensors it runs the plain PyTorch version
of the same function, which lives here too.  Plain versions run on any
device; ``PLAIN_CUDA_CALLS`` counts the calls they get with CUDA tensors,
which only the on-card comparison of a kernel with its plain version
makes.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from ..constants import hist_width
from . import build

NAMES = ("hist", "left_hist", "moment", "moment2")
LAUNCHES: Dict[str, int] = dict.fromkeys(NAMES, 0)
PLAIN_CUDA_CALLS: Dict[str, int] = dict.fromkeys(NAMES, 0)


def reset_counts() -> None:
    for name in NAMES:
        LAUNCHES[name] = 0
        PLAIN_CUDA_CALLS[name] = 0


# ---------------------------------------------------------------------------
# argument checks and launch
# ---------------------------------------------------------------------------

def _check(ch, cf, cd, ms, rlens, k: int,
           tables: Sequence[torch.Tensor] = ()) -> Tuple[int, int, int, int]:
    """Validates one batch; returns (B, lanes, H, R)."""
    if k not in (10, 20, 30, 40):
        raise ValueError(f"k must be 10, 20, 30 or 40, got {k}")
    if ch.dim() != 3:
        raise ValueError(f"ch must be (B, lanes, H), got {tuple(ch.shape)}")
    B, lanes, H = ch.shape
    R = cf.shape[-1]
    if lanes != -(-k // 8):
        raise ValueError(f"k={k} needs {-(-k // 8)} code lanes, got {lanes}")
    W = hist_width(H, R)
    want = [("ch", ch, torch.int32, (B, lanes, H)),
            ("cf", cf, torch.int32, (B, lanes, R)),
            ("cd", cd, torch.int32, (B, lanes, R)),
            ("ms", ms, torch.int32, (B,)),
            ("rlens", rlens, torch.int32, (B,))]
    want += [(f"table{n}", t, torch.bool, (B, W))
             for n, t in enumerate(tables)]
    for name, t, dtype, shape in want:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != ch.device:
            raise ValueError(f"{name} is on {t.device}, ch on {ch.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if ch.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {ch.device}")
    return B, lanes, H, R


def _launch(name: str, device: torch.device, *args) -> None:
    fn = build.entry_point(name)
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in args]
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    err = fn(*ptrs, index, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


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
    scal = torch.tensor([[0, 0, H + 1, -1]] * B, dtype=torch.int32,
                        device=ch.device)
    for b, (i, j, f, r) in _rows(ch, cf, cd, ms, rlens, k):
        mult = (f + r).int()
        h_d[b].index_add_(0, j - i + H, mult)
        h_a[b].index_add_(0, j + i, mult)
        if i.numel():
            scal[b] = torch.stack([f.sum(), r.sum(), i.min(), i.max()])
    return h_d, h_a, scal


def left_hist_plain(ch, cf, cd, ms, rlens, k: int, keep_d):
    _note_plain("left_hist", ch)
    B, _, H = ch.shape
    h_a = torch.zeros(keep_d.shape, dtype=torch.int32, device=ch.device)
    for b, (i, j, f, r) in _rows(ch, cf, cd, ms, rlens, k):
        left = ~keep_d[b][j - i + H]
        h_a[b].index_add_(0, (j + i)[left], (f + r)[left].int())
    return h_a


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


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def hist(ch, cf, cd, ms, rlens, k: int):
    """-> h_d (B, W) int32 over j - i + H, h_a (B, W) int32 over j + i,
    each summing hit multiplicity, and scal (B, 4) int32 =
    [forward hits, reverse hits, first hit row (H + 1 if none), last hit
    row (-1 if none)]."""
    B, lanes, H, R = _check(ch, cf, cd, ms, rlens, k)
    if ch.device.type == "cpu":
        return hist_plain(ch, cf, cd, ms, rlens, k)
    W = hist_width(H, R)
    h_d = torch.zeros((B, W), dtype=torch.int32, device=ch.device)
    h_a = torch.zeros_like(h_d)
    scal = torch.tensor([0, 0, H + 1, -1], dtype=torch.int32,
                        device=ch.device).repeat(B, 1)
    _launch("hist", ch.device, ch, cf, cd, ms, rlens, B, H, R, lanes, k,
            W, h_d, h_a, scal)
    return h_d, h_a, scal


def left_hist(ch, cf, cd, ms, rlens, k: int, keep_d):
    """-> (B, W) int32 histogram over j + i of the hit multiplicity of
    cells whose bin j - i + H is not set in keep_d."""
    B, lanes, H, R = _check(ch, cf, cd, ms, rlens, k, (keep_d,))
    if ch.device.type == "cpu":
        return left_hist_plain(ch, cf, cd, ms, rlens, k, keep_d)
    W = hist_width(H, R)
    h_a = torch.zeros((B, W), dtype=torch.int32, device=ch.device)
    _launch("left_hist", ch.device, ch, cf, cd, ms, rlens, B, H, R, lanes,
            k, W, keep_d, h_a)
    return h_a


def moment(ch, cf, cd, ms, rlens, k: int, keep_d, keep_a,
           want_w10: bool):
    """-> (B, 3) int64 [count, sum |d|, within-10% count (0 unless
    want_w10)] over cells kept by keep_d | keep_a, d = j - (i - m)."""
    B, lanes, H, R = _check(ch, cf, cd, ms, rlens, k, (keep_d, keep_a))
    if ch.device.type == "cpu":
        return moment_plain(ch, cf, cd, ms, rlens, k, keep_d, keep_a,
                            want_w10)
    mom = torch.zeros((B, 3), dtype=torch.int64, device=ch.device)
    _launch("moment", ch.device, ch, cf, cd, ms, rlens, B, H, R, lanes, k,
            hist_width(H, R), keep_d, keep_a, int(want_w10), mom)
    return mom


def moment2(ch, cf, cd, ms, rlens, k: int, keep_d1, keep_a1, keep_d2,
            keep_a2):
    """-> (B, 6) int64: moment(keep_d1, keep_a1, want_w10=False) beside
    moment(keep_d2, keep_a2, want_w10=True), in one pass."""
    B, lanes, H, R = _check(ch, cf, cd, ms, rlens, k,
                            (keep_d1, keep_a1, keep_d2, keep_a2))
    if ch.device.type == "cpu":
        return moment2_plain(ch, cf, cd, ms, rlens, k, keep_d1, keep_a1,
                             keep_d2, keep_a2)
    mom = torch.zeros((B, 6), dtype=torch.int64, device=ch.device)
    _launch("moment2", ch.device, ch, cf, cd, ms, rlens, B, H, R, lanes,
            k, hist_width(H, R), keep_d1, keep_a1, keep_d2, keep_a2, mom)
    return mom
