"""Call-set layout, genome and long-read stream of one cell, in numpy.

Two seeds draw everything the program is fed.  The configuration's
``layout_seed`` fixes the work: each event's type, size, genotype and
place, its reads' count, lengths, starts and haplotypes, and the gap
after it.  Every contig holds the same events in the same places.  The
run's ``--seed`` draws the sequences: the genome, the insert sequences,
each read's errors and its strand.  So every seed gives the same work
on other bases (records parsed vary by the errors' CIGAR ops alone),
and the reads of one event can be drawn again on their own
(``event_reads``) for the reference after the window.

Coordinates follow VaPoR's reading of a call (validators.py, pyx:1701+):
``s`` and ``e`` are 1-based and inclusive, a DEL removes bases s..e, an
INV reverses them, a tandem DUP repeats them once, and an INS puts its
sequence after base s.  The donor haplotype is built so that VaPoR's
alternative haplotype is the truth.

Reads cover the union of the fetch windows that VaPoR may query for the
event (``fetch_window``) at the traffic's depth: each read's start is
uniform over [window start - read length + 1, window end], the set a
real BAM returns for that region.  Events are spaced so that no read of
one event overlaps another event's window.  A donor read's CIGAR holds
its errors and the event itself: the deleted bases as a D run, inserted
or duplicated bases as an I run, an inversion as an I run followed by a
D run over the inverted bases.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

# BAM CIGAR operation codes (SAM spec 4.2)
M, I, D, S = 0, 1, 2, 4
_NONE = 255
ASCII = np.frombuffer(b"ACGT", np.uint8)

# VaPoR's constants that place the fetch windows (config.py, pyx:22-26)
DEFAULT_FLANK = 500
MAX_SV_TEST = 10000


@dataclass(frozen=True)
class Shape:
    """One event of the layout: the same on every contig and seed."""
    kind: str                 # DEL, INS, INV or DUP
    size: int                 # bases deleted, inserted, inverted, repeated
    hom: bool
    read_lengths: Tuple[int, ...]
    read_starts: Tuple[int, ...]  # 0-based, from the window's start
    donor: Tuple[bool, ...]   # which reads come from the donor haplotype
    gap: int                  # spare bases before the next event's reach


@dataclass
class Event:
    """One placed event of one contig."""
    contig: str
    shape_id: int
    kind: str
    size: int
    hom: bool
    s: int                    # VaPoR coordinates, 1-based inclusive
    e: int
    ws: int                   # union of the fetch windows, 1-based incl
    we: int
    lo: int                   # 0-based [lo, hi): where its reads may lie
    hi: int
    svid: str
    ins: bytes = b""          # INS sequence (ASCII), drawn per seed


def flank(kind: str, size: int) -> int:
    """VaPoR's flank: ``flank_length_calculate`` on the span e - s, and
    the INS rule (validators.validate_ins_gen)."""
    if kind == "INS":
        return DEFAULT_FLANK if size > DEFAULT_FLANK else size
    return min(size - 1, DEFAULT_FLANK)


def fetch_window(kind: str, s: int, size: int) -> Tuple[int, int]:
    """Union of every window VaPoR's validator may read for the event
    (1-based inclusive): the whole-event window and its junction
    fallback, or the junction window alone for a span of 10 kb or more."""
    f = flank(kind, size)
    e = s + size - 1
    span = e - s
    if kind == "DEL":
        return s - f, s + f
    if kind == "INV":
        return (s - f, e + f) if span < MAX_SV_TEST else (s - f, s + f)
    if kind == "DUP":
        return (s - f, s + 2 * span + f) if span < MAX_SV_TEST \
            else (e - f, e + f)
    if kind == "INS":
        return s - f, s + size + f
    raise ValueError(kind)


def _ref_extent(kind: str, size: int) -> int:
    """Reference bases a donor read spans beyond its own length."""
    return size if kind in ("DEL", "INV") else 0


def _exact_counts(shares: List[float], n: int) -> List[int]:
    """Largest-remainder split of n by the shares."""
    raw = [s * n / sum(shares) for s in shares]
    out = [int(math.floor(r)) for r in raw]
    order = sorted(range(len(raw)), key=lambda i: -(raw[i] - out[i]))
    for i in order[:n - sum(out)]:
        out[i] += 1
    return out


def read_length_mean(traffic: Dict) -> float:
    """Mean of the traffic's clipped log-normal read length."""
    rl = traffic["read_length"]
    x = np.random.default_rng(0).lognormal(
        math.log(rl["median"]), rl["sigma"], 1 << 20)
    return float(np.clip(x, rl["min"], rl["max"]).mean())


def make_layout(config: Dict, traffic: Dict) -> List[Shape]:
    """The events of one contig, fixed by the configuration's
    layout_seed: exact type, size-bin and genotype counts, sizes
    log-uniform within their bin, read counts from the window's width at
    the traffic's depth, each read's length, start and haplotype."""
    rng = np.random.default_rng(int(config["layout_seed"]))
    n = int(config["events_per_contig"])
    kinds = [k for k, c in zip(config["types"], _exact_counts(
        list(config["types"].values()), n)) for _ in range(c)]
    bins = config["sizes"]
    sizes = []
    for (lo, hi, _), c in zip(bins, _exact_counts([b[2] for b in bins], n)):
        sizes += [int(math.exp(v)) for v in
                  rng.uniform(math.log(lo), math.log(hi), c)]
    n_hom = _exact_counts([1 - config["hom_share"], config["hom_share"]],
                          n)[1]
    hom = [True] * n_hom + [False] * (n - n_hom)
    kinds = [kinds[i] for i in rng.permutation(n)]
    sizes = [sizes[i] for i in rng.permutation(n)]
    hom = [hom[i] for i in rng.permutation(n)]
    rl = traffic["read_length"]
    mean_len = read_length_mean(traffic)
    shapes = []
    reach = []
    for kind, size, h in zip(kinds, sizes, hom):
        ws, we = fetch_window(kind, 1, size)
        count = int(round(traffic["depth"] * (we - ws + 1 + mean_len)
                          / mean_len))
        lengths = np.clip(rng.lognormal(math.log(rl["median"]),
                                        rl["sigma"], count),
                          rl["min"], rl["max"]).astype(np.int64)
        starts = 1 - lengths + (rng.random(count) *
                                (we - ws + lengths)).astype(np.int64)
        donor = np.zeros(count, bool)
        donor[rng.permutation(count)[:count if h else count // 2]] = True
        shapes.append((kind, size, h, tuple(int(x) for x in lengths),
                       tuple(int(x) for x in starts),
                       tuple(bool(x) for x in donor)))
        reach.append(_span(kind, size, ws, we, rl["max"]))
    spare = max(0.0, config["spacing_mean_bp"] - float(np.mean(reach)))
    gaps = rng.integers(0, int(2 * spare) + 1, n)
    return [Shape(*sh, int(g)) for sh, g in zip(shapes, gaps)]


def _span(kind: str, size: int, ws: int, we: int, lmax: int) -> int:
    """Bases from one event's window start to the next one's at the
    least spacing: the window, then its reads' reach to the right."""
    return (we - ws) + lmax + _ref_extent(kind, size) + 3


def place(layout: List[Shape], contig: str, order: np.ndarray,
          lmax: int) -> Tuple[List[Event], int]:
    """Events of one contig in the given order, and the contig's length.
    Reads of an event lie in [lo, hi), and the next window starts past
    hi: no read of one event overlaps another's window, and no read
    meets another event's change to the genome."""
    events = []
    cursor = lmax + 1000            # 0-based start of the next window
    for rank, sid in enumerate(order):
        sh = layout[int(sid)]
        rel_ws, rel_we = fetch_window(sh.kind, 1, sh.size)
        ws = cursor + 1             # 1-based window start
        s = ws - rel_ws + 1
        e = s + sh.size - 1 if sh.kind != "INS" else s
        we = ws + (rel_we - rel_ws)
        lo = ws - 1 - lmax
        hi = we + lmax + _ref_extent(sh.kind, sh.size) + 2
        events.append(Event(contig, int(sid), sh.kind, sh.size, sh.hom,
                            s, e, ws, we, lo, hi,
                            f"{contig}_{sh.kind}_{rank}"))
        cursor = hi + sh.gap
    return events, cursor + 1000


def contig_names(traffic: Dict) -> List[str]:
    return [f"chr{i + 1}" for i in range(int(traffic["contigs"]))]


def _stream(seed: int, *salt: int) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 63), *salt])


def genome(seed: int, contig_index: int, length: int) -> np.ndarray:
    """Uniform random bases of one contig, as codes 0-3 (ACGT)."""
    return _stream(seed, contig_index, 0).integers(0, 4, length,
                                                   dtype=np.uint8)


def contig_events(layout: List[Shape], seed: int, contig_index: int,
                  contig: str, lmax: int) -> Tuple[List[Event], int]:
    """The contig's placed events, in the layout's order, and its length;
    INS sequences are drawn from the seed per event."""
    events, length = place(layout, contig, np.arange(len(layout)), lmax)
    for rank, ev in enumerate(events):
        if ev.kind == "INS":
            ev.ins = ASCII[_stream(seed, contig_index, 2, rank).integers(
                0, 4, ev.size)].tobytes()
    return events, length


def _complement_reverse(codes: np.ndarray) -> np.ndarray:
    return (3 - codes)[::-1]


def _template(ev: Event, g: np.ndarray, donor: bool):
    """(op type, base code, reference position) of each template entry
    over [lo, hi): all M for the reference haplotype; the donor's with
    the event's I and D entries."""
    lo, hi = ev.lo, ev.hi
    if not donor:
        return (np.zeros(hi - lo, np.uint8), g[lo:hi],
                np.arange(lo, hi, dtype=np.int64))
    s0, e0 = ev.s - 1, ev.e              # 0-based [s0, e0) = bases s..e
    parts = []

    def seg(typ, base, rpos):
        parts.append((np.full(len(base), typ, np.uint8), base, rpos))

    def ref(a, b):
        seg(M, g[a:b], np.arange(a, b, dtype=np.int64))

    def gone(a, b):
        seg(D, np.zeros(b - a, np.uint8), np.arange(a, b, dtype=np.int64))

    def added(codes, at):
        seg(I, codes, np.full(len(codes), at, np.int64))

    if ev.kind == "DEL":
        ref(lo, s0), gone(s0, e0), ref(e0, hi)
    elif ev.kind == "INV":
        ref(lo, s0), added(_complement_reverse(g[s0:e0]), e0)
        gone(s0, e0), ref(e0, hi)
    elif ev.kind == "DUP":
        ref(lo, e0), added(g[s0:e0].copy(), e0), ref(e0, hi)
    elif ev.kind == "INS":
        codes = np.searchsorted(ASCII, np.frombuffer(ev.ins, np.uint8))
        ref(lo, ev.s), added(codes.astype(np.uint8), ev.s), ref(ev.s, hi)
    else:
        raise ValueError(ev.kind)
    return tuple(np.concatenate(x) for x in zip(*parts))


@dataclass
class Reads:
    """One event's reads in file order (sorted by position)."""
    pos: np.ndarray           # 0-based leftmost position
    end: np.ndarray           # 0-based exclusive end on the reference
    flag: np.ndarray
    cigar: List[np.ndarray]   # uint32 words (len << 4 | op)
    seq: List[np.ndarray]     # codes 0-3
    names: List[str]

    def cigar_text(self, i: int) -> str:
        w = self.cigar[i]
        return "".join(f"{n}{'MIDNSHP=X'[o]}" for n, o in
                       zip((w >> 4).tolist(), (w & 15).tolist()))

    def seq_text(self, i: int) -> str:
        return ASCII[self.seq[i]].tobytes().decode("ascii")


def event_reads(ev: Event, shape: Shape, g: np.ndarray, seed: int,
                contig_index: int, rank: int, error: Dict) -> Reads:
    """Draw the event's reads: start, haplotype, errors, CIGAR."""
    rng = _stream(seed, contig_index, 3, rank)
    lengths = np.asarray(shape.read_lengths, np.int64)
    n = len(lengths)
    donor = np.asarray(shape.donor, bool)
    starts = ev.ws - 1 + np.asarray(shape.read_starts, np.int64)
    flags = np.where(rng.random(n) < 0.5, 0, 16).astype(np.int64)

    temps = [_template(ev, g, False), _template(ev, g, True)]
    typ = np.concatenate([temps[0][0], temps[1][0]])
    base = np.concatenate([temps[0][1], temps[1][1]])
    rpos = np.concatenate([temps[0][2], temps[1][2]])
    off = len(temps[0][0])
    nond = np.cumsum(typ != D)
    m_idx = np.flatnonzero(typ == M)
    first = np.empty(n, np.int64)
    ref_reads = ~donor
    first[ref_reads] = starts[ref_reads] - ev.lo
    dm = m_idx[m_idx >= off]
    first[donor] = dm[np.minimum(np.searchsorted(rpos[dm], starts[donor]),
                                 len(dm) - 1)]
    before = nond[first] - 1
    limit = np.where(donor, len(typ), off)
    last = np.minimum(np.searchsorted(nond, before + lengths) + 1, limit)
    counts = last - first
    rid = np.repeat(np.arange(n), counts)
    flat = _ranges(first, last)
    return _mutate(typ[flat], base[flat], rpos[flat], rid, n, rng, error,
                   flags, ev, lengths)


def _ranges(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Concatenated aranges [lo[i], hi[i])."""
    n = np.maximum(hi - lo, 0)
    start = np.cumsum(n) - n
    return np.repeat(lo - start, n) + np.arange(int(n.sum()))


def _mutate(typ, base, rpos, rid, n, rng, error, flags, ev, lengths
            ) -> Reads:
    """Errors (substitution, insertion, deletion at the traffic's
    shares), then the CIGAR: leading and trailing insertions soft-clipped,
    leading and trailing deletions dropped."""
    rate = error["rate"]
    w = np.asarray([error["sub"], error["ins"], error["del"]], float)
    cut = np.cumsum(w / w.sum() * rate)
    u = rng.random(len(typ), dtype=np.float32)
    hit = np.flatnonzero((typ != D) & (u < cut[2]))
    what = np.searchsorted(cut, u[hit], "right")
    sub, ins, dele = hit[what == 0], hit[what == 1], hit[what == 2]
    out_base = base.copy()
    out_base[sub] = (base[sub] + rng.integers(1, 4, len(sub),
                                              dtype=np.uint8)) % 4
    main = typ.copy()
    main[dele] = np.where(typ[dele] == M, D, _NONE)
    ops = np.insert(main, ins, I)
    bases = np.insert(out_base, ins, rng.integers(0, 4, len(ins),
                                                  dtype=np.uint8))
    orpos = np.insert(rpos, ins, rpos[ins])
    orid = np.insert(rid, ins, rid[ins])
    keep = ops != _NONE
    if not keep.all():
        ops, bases, orpos, orid = ops[keep], bases[keep], orpos[keep], \
            orid[keep]
    m_at = np.flatnonzero(ops == M)
    m_rid = orid[m_at]
    reads = np.arange(n)
    first_m = m_at[np.searchsorted(m_rid, reads, "left")]
    last_m = m_at[np.searchsorted(m_rid, reads, "right") - 1]
    lead = _ranges(np.searchsorted(orid, reads, "left"), first_m)
    trail = _ranges(last_m + 1, np.searchsorted(orid, reads, "right"))
    ends = np.concatenate([lead, trail])
    ops[ends[ops[ends] == I]] = S
    gone = ends[ops[ends] == D]
    if len(gone):
        keep = np.ones(len(ops), bool)
        keep[gone] = False
        ops, bases, orid = ops[keep], bases[keep], orid[keep]
    pos = orpos[first_m]

    brk = np.ones(len(ops), bool)
    brk[1:] = (ops[1:] != ops[:-1]) | (orid[1:] != orid[:-1])
    run_at = np.flatnonzero(brk)
    run_len = np.diff(np.append(run_at, len(ops))).astype(np.uint32)
    run_op = ops[run_at].astype(np.uint32)
    run_rid = orid[run_at]
    words = (run_len << 4) | run_op
    refspan = np.bincount(run_rid, weights=run_len * ((run_op == M) |
                                                      (run_op == D)),
                          minlength=n).astype(np.int64)
    cig_cut = np.searchsorted(run_rid, np.arange(n + 1))
    has_base = ops != D
    seq_codes = bases[has_base]
    seq_rid = orid[has_base]
    seq_cut = np.searchsorted(seq_rid, np.arange(n + 1))
    order = np.argsort(pos, kind="stable")
    ci = ev.contig[3:]
    return Reads(
        pos=pos[order], end=(pos + refspan)[order], flag=flags[order],
        cigar=[words[cig_cut[i]:cig_cut[i + 1]] for i in order],
        seq=[seq_codes[seq_cut[i]:seq_cut[i + 1]] for i in order],
        names=[f"m64011_190830_220126/{ci}{ev.shape_id:04d}{int(i):03d}/"
               f"0_{int(lengths[i])}" for i in order])
