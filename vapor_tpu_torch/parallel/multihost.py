"""Multi-host execution: contig-sharded worklists over torch.distributed.

The reference's only scale-out is file-based WDL scatter (SURVEY §2.5).
Here:

* each process joins a ``torch.distributed`` process group (torchrun's
  environment: RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK)
  and owns a deterministic shard of the worklist: by contig when
  contigs >= processes (BAM/FASTA locality, zero cross-process reads),
  in contiguous position blocks when one contig would dominate, round
  robin by event otherwise;
* each process scores its shard on its own card,
  ``cuda:{LOCAL_RANK % device_count}`` (``rank_device``), so several
  ranks may share one card, and splits a call's rows over that card
  only (``one_of_several``, parallel.mesh): ranks never score on each
  other's cards;
* result rows are fixed-width text; the merge is either the
  orchestrator's deterministic file merge (orchestrate.merge_outputs)
  or ``allgather_rows``, an in-job gather of row blocks in rank order
  when a single output is produced in-process.

The collectives run on the gloo backend: they carry host text rows, and
no device collective exists (the JAX package's mesh ``psum`` result is
thrown away), while NCCL would refuse two ranks on one card.  A single
process (no WORLD_SIZE, or 1) is rank 0 of 1.
"""
from __future__ import annotations

import datetime
import os
from typing import Dict, List, Optional, Sequence, Tuple

# how long a collective (the process group's rendezvous included) may
# wait for the other ranks before it raises
TIMEOUT = datetime.timedelta(minutes=10)


def initialize() -> Tuple[int, int]:
    """Joins the gloo process group that torchrun's environment
    describes (init_method "env://") when WORLD_SIZE is above 1.

    Returns (rank, world size); (0, 1) standalone."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return 0, 1
    import torch.distributed as dist
    if not dist.is_initialized():
        dist.init_process_group("gloo", init_method="env://",
                                timeout=TIMEOUT)
    return dist.get_rank(), dist.get_world_size()


def finalize() -> None:
    """Leaves the process group, if this process joined one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def one_of_several() -> bool:
    """Whether this process is one of several that share the host's
    cards: a torchrun rank (WORLD_SIZE > 1), or a scatter shard, to which
    orchestrate.run_scatter gives torchrun's LOCAL_RANK and
    LOCAL_WORLD_SIZE (> 1) but no process group."""
    return any(int(os.environ.get(name, "1")) > 1
               for name in ("WORLD_SIZE", "LOCAL_WORLD_SIZE"))


def rank_device(device: str) -> str:
    """This process's card for a "cuda" run, cuda:{LOCAL_RANK % cards};
    any other device (and a run with no card, which the backend refuses)
    unchanged."""
    if device != "cuda":
        return device
    import torch
    n = torch.cuda.device_count()
    if n == 0:
        return device
    return f"cuda:{int(os.environ.get('LOCAL_RANK', '0')) % n}"


def contig_of_event(e) -> str:
    """Contig name of a worklist entry.  Block-structured entries
    (DEL_INV: [[chr, s, e], [chr, s, e]]) nest the contig one level
    down — unwrap so every SV type keys on the same contig string."""
    c = e[0]
    while isinstance(c, (list, tuple)):
        c = c[0]
    return str(c)


def contig_owner(events: Sequence, num_processes: int,
                 contig_of=contig_of_event) -> Optional[Dict[str, int]]:
    """Greedy-balanced contig -> host map over a full worklist, or
    None when there are fewer contigs than hosts (callers then fall
    back to event round-robin).  Computing this ONCE over the combined
    event list — not per SV type — keeps per-host BAM regions disjoint
    even when types have different per-contig counts (ADVICE r3).
    Deterministic: every host computes the same assignment."""
    contigs = []
    counts: Dict[str, int] = {}
    for e in events:
        c = contig_of(e)
        if c not in counts:
            contigs.append(c)
            counts[c] = 0
        counts[c] += 1
    if len(contigs) < num_processes:
        return None
    # largest contig first onto the least-loaded host (greedy
    # balance; first-appearance order breaks count ties)
    first = {c: i for i, c in enumerate(contigs)}
    order = sorted(contigs, key=lambda c: (-counts[c], first[c]))
    load = [0] * num_processes
    owner: Dict[str, int] = {}
    for c in order:
        h = min(range(num_processes), key=lambda i: (load[i], i))
        owner[c] = h
        load[h] += counts[c]
    return owner


def _event_ints(e) -> List[int]:
    """Every integer-valued field of a (possibly nested) worklist
    entry — coordinates arrive as ints or numeric strings depending on
    the parser."""
    out: List[int] = []

    def rec(x):
        if isinstance(x, (list, tuple)):
            for v in x:
                rec(v)
        elif isinstance(x, bool):
            pass
        elif isinstance(x, int):
            out.append(x)
        elif isinstance(x, str) and x.isdigit():
            out.append(int(x))

    rec(e)
    return out


def event_pos(e) -> int:
    """Leftmost coordinate of a worklist entry (block-assignment key)."""
    ns = _event_ints(e)
    return min(ns) if ns else 0


# ALT-haplotype span multiplier by SV type: the validator scores each
# read against BOTH haplotypes, and the ALT length varies ~3x by type
# (DEL alt = flanks only, DUP/TANDUP alt = 2x span + flanks —
# validators.py ALT synthesis).  Ignoring this made per-contig cost
# predictions systematically wrong on equal-count worklists, which is
# exactly the case where LPT has nothing to move (SCALING_r5 run 1-2:
# the same shard heavy in both runs).
_ALT_SPAN_W = {"DEL": 0.0, "INS": 0.3, "INV": 1.0, "DUP": 2.0,
               "TANDUP": 2.0, "DISDUP": 2.0, "DUP_INV": 2.0,
               "DEL_INV": 1.0, "CNV": 1.0}


def _event_svtype(e) -> Optional[str]:
    """First recognizable SV-type token in a (possibly nested) entry."""
    out: List[str] = []

    def rec(x):
        if isinstance(x, (list, tuple)):
            for v in x:
                rec(v)
        elif isinstance(x, str) and x.upper() in _ALT_SPAN_W:
            out.append(x.upper())

    rec(e)
    return out[0] if out else None


def event_cost(e) -> float:
    """Rough device-cost estimate for load balancing.  Per-read engine
    work scales with the haplotype bucket (H x R cells at ~constant
    read length R), so cost ~ ref hap length + alt hap length, where
    ref ~ span + 2*flank (flank_length_calculate semantics, pyx:794)
    and alt ~ w*span + 2*flank with a per-type multiplier w
    (_ALT_SPAN_W); events above the 10 kb whole-event cap run
    fixed-shape 2x500 junction dotplots (pyx:1729).  The constant
    covers per-event host work (parse, window refinement dispatch,
    genotyping)."""
    ns = _event_ints(e)
    span = (max(ns) - min(ns)) if len(ns) >= 2 else 300
    if span >= 10000:
        return 2000.0 + 400.0
    f = min(span, 500)
    w = _ALT_SPAN_W.get(_event_svtype(e) or "", 1.0)
    return float((span + 2 * f) + (w * span + 2 * f)) + 400.0


class EventOwner:
    """Deterministic (contig, position-block) -> host assignment.

    Blocks are contiguous genomic ranges, so per-host BAM reads stay
    disjoint region sets even when a contig is split across hosts
    (BAI random access makes region-level locality the unit that
    matters; whole-contig locality was only a WDL-container concern).
    """

    def __init__(self, blocks: Dict[str, Tuple[List[int], List[int]]]):
        # contig -> (block start positions b_1..b_{k-1}, hosts[0..k-1])
        self._blocks = blocks
        self._warned: set = set()

    def host_of(self, e, contig_of=contig_of_event) -> int:
        import bisect
        c = contig_of(e)
        ent = self._blocks.get(c)
        if ent is None:
            # only entries excluded from the assignment list (e.g.
            # 'NA' rows) can be unmapped; route to host 0 but say so
            # (ADVICE r4: never silently skew a stale map)
            if c not in self._warned:
                self._warned.add(c)
                import warnings
                warnings.warn(
                    f"contig {c!r} missing from the shard assignment; "
                    "routing its events to shard 0")
            return 0
        starts, hosts = ent
        return hosts[bisect.bisect_right(starts, event_pos(e))]


def balanced_owner(events: Sequence, num_processes: int,
                   contig_of=contig_of_event,
                   imbalance_tol: float = 1.05) -> Optional[EventOwner]:
    """Cost-weighted LPT assignment with contig splitting.

    First tries contig granularity (greedy by estimated cost).  If the
    predicted max load exceeds ``imbalance_tol`` x ideal — the 8-host
    knee in SCALING_r3 was exactly this: equal event counts, unequal
    costs, one contig per host with nothing movable — contigs costing
    more than half the ideal host load are split into contiguous
    position blocks of at most that size and the blocks are repacked.
    Returns None when there are fewer blocks than hosts even after
    splitting (callers round-robin by event)."""
    if num_processes <= 1:
        return None
    groups: Dict[str, List[Tuple[int, float]]] = {}
    order: List[str] = []
    for e in events:
        c = contig_of(e)
        if c not in groups:
            groups[c] = []
            order.append(c)
        groups[c].append((event_pos(e), event_cost(e)))
    total = sum(c for g in groups.values() for _, c in g)
    if total <= 0 or not groups:
        return None
    ideal = total / num_processes
    # block granularity: a third of the ideal host load.  ideal/2 left
    # LPT packing ~17% over ideal on chunky mixes (a host ends up one
    # near-cap block heavy); finer than ~ideal/3 fragments regions for
    # no packing gain
    cap = ideal / 3.0

    def make_blocks(split: bool):
        """[(cost, order_i, block_i, contig, start_bound)]; bounds are
        the first position of each non-initial block."""
        blocks = []
        bounds: Dict[str, List[int]] = {}
        for oi, c in enumerate(order):
            g = sorted(groups[c])
            csum = sum(cost for _, cost in g)
            bounds[c] = []
            if not split or csum <= cap or len(g) <= 1:
                blocks.append((csum, oi, 0, c))
                continue
            run_cost, prev_pos, bi = 0.0, None, 0
            for pos, cost in g:
                # never cut between equal positions: the bisect lookup
                # must map every event of one position to one block
                if run_cost > 0 and run_cost + cost > cap \
                        and pos != prev_pos:
                    blocks.append((run_cost, oi, bi, c))
                    bounds[c].append(pos)
                    bi += 1
                    run_cost = 0.0
                run_cost += cost
                prev_pos = pos
            blocks.append((run_cost, oi, bi, c))
        return blocks, bounds

    def pack(blocks):
        load = [0.0] * num_processes
        host_of = {}
        for cost, oi, bi, c in sorted(
                blocks, key=lambda b: (-b[0], b[1], b[2])):
            h = min(range(num_processes), key=lambda i: (load[i], i))
            host_of[(c, bi)] = h
            load[h] += cost
        return host_of, max(load)

    blocks, bounds = make_blocks(split=False)
    # keep contig granularity whenever the prediction balances: an
    # experiment that force-split at ~1 contig/host to average
    # content-dependent cost noise made the 8-host curve WORSE (0.72
    # vs 0.87 — LPT by estimated cost concentrates the estimation
    # error it cannot see), so splitting stays reserved for predicted
    # imbalance
    if len(blocks) >= num_processes:
        host_of, max_load = pack(blocks)
        if max_load <= imbalance_tol * ideal:
            return EventOwner({c: ([], [host_of[(c, 0)]])
                               for c in order})
    blocks, bounds = make_blocks(split=True)
    if len(blocks) < num_processes:
        return None
    host_of, _ = pack(blocks)
    table: Dict[str, Tuple[List[int], List[int]]] = {}
    for c in order:
        k = 1 + len(bounds[c])
        table[c] = (bounds[c], [host_of[(c, bi)] for bi in range(k)])
    return EventOwner(table)


def shard_worklist(events: Sequence, process_id: int, num_processes: int,
                   contig_of=contig_of_event,
                   owner=None) -> List:
    """Deterministic worklist shard for this host.

    Default assignment is cost-weighted contiguous-block packing
    (balanced_owner): contig-granular when that balances, contiguous
    sub-contig blocks when one contig would dominate a host, event
    round-robin when there is too little structure to split.  Pass
    ``owner`` (from balanced_owner over the FULL worklist) to share
    one assignment across several per-type calls; a plain
    {contig: host} dict is also accepted (legacy contig_owner maps).
    """
    if num_processes <= 1:
        return list(events)
    if owner is None:
        owner = balanced_owner(events, num_processes, contig_of)
    if isinstance(owner, dict):
        import warnings
        missing = {contig_of(e) for e in events} - set(owner)
        if missing:
            warnings.warn(
                f"contigs {sorted(missing)} missing from the provided "
                "shard map; routing their events to shard 0")
        return [e for e in events
                if owner.get(contig_of(e), 0) == process_id]
    if owner is not None:
        return [e for e in events
                if owner.host_of(e, contig_of) == process_id]
    return [e for i, e in enumerate(events)
            if i % num_processes == process_id]


def allgather_rows(rows: List[List[str]]) -> List[List[str]]:
    """Gathers every process's result rows to every process, in rank
    order (fixed-width text rows encoded as bytes; replaces the
    file-based ConcatVaPoR merge).  Returns `rows` itself outside a
    process group."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()) or \
            dist.get_world_size() == 1:
        return rows
    import numpy as np
    import torch
    n = dist.get_world_size()
    blob = ("\x1e".join("\x1f".join(r) for r in rows)).encode()
    # agree on the buffer width before building it: all_gather needs
    # same-shaped tensors, so the width is the gathered maximum length
    lengths = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
    dist.all_gather(lengths, torch.tensor([len(blob)], dtype=torch.int64))
    width = max(1, max(int(x) for x in lengths))
    buf = torch.zeros(width, dtype=torch.uint8)
    buf[:len(blob)] = torch.from_numpy(np.frombuffer(blob, np.uint8).copy())
    gathered = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(gathered, buf)
    out: List[List[str]] = []
    for got, length in zip(gathered, lengths):
        text = got[:int(length)].numpy().tobytes().decode()
        if text:
            out.extend(r.split("\x1f") for r in text.split("\x1e"))
    return out
