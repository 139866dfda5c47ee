"""How ``correct`` is decided: the program's rows against the reference's.

After the window, every completed call's output must hold exactly one
row for each call of its call set (``rows_missing_or_extra``), every
call must have exited 0 (``calls_failed``), and the rows of a sample of
events drawn from the seed, the heaviest of each contig among them, must
equal, byte for byte, the rows the plain reference works out from the
generator's own records (``rows_wrong``, over every copy of each
sampled row in every completed call).  Each number's limit is 0: the
comparison is exact.

The control (``control``) is the reference with the configuration's
control step put in the program's place: one call a contig, each with
the control's row of every call in it, judged as a run is.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, List, Tuple

import numpy as np

from .gen.layout import ASCII
from .reference.vapor import Records, Reference

LIMITS = {"rows_wrong": 0, "rows_missing_or_extra": 0, "calls_failed": 0}


def passed(numbers: Dict) -> bool:
    return all(numbers[k]["value"] <= numbers[k]["limit"] for k in LIMITS)


def sample(inputs, contigs: List[str], seed: int, k: int):
    """k events of the given contigs drawn from the seed: the heaviest
    quarter by fetch window and size, and the rest at random."""
    pool = [ev for c in contigs for ev in inputs.events[c]]
    heavy = max(1, k // 4)
    by_weight = sorted(pool, key=lambda ev: -(ev.we - ev.ws + ev.size))
    chosen = by_weight[:heavy]
    rest = [ev for ev in pool if ev not in chosen]
    rng = np.random.default_rng([seed % (1 << 63), 99])
    chosen += [rest[i] for i in rng.permutation(len(rest))[:k - heavy]]
    return chosen


def _call_lines(inputs) -> Dict[str, str]:
    """VCF data line of each call, by ID, as the generator wrote it."""
    out = {}
    with open(inputs.calls) as fh:
        for line in fh:
            if not line.startswith("#") and line.strip():
                out[line.split("\t")[2]] = line.rstrip("\n")
    return out


def reference_rows(inputs, events, ref: Reference) -> Dict[str, str]:
    """The reference's row of each event, by its ID."""
    lines = _call_lines(inputs) if inputs.mode == "vcf" else {}
    out = {}
    genomes: Dict[str, Tuple[np.ndarray, str]] = {}
    for ev in events:
        if ev.contig not in genomes:
            g = inputs.genome(ev.contig)
            genomes[ev.contig] = (g, ASCII[g].tobytes().decode("ascii"))
        g, text = genomes[ev.contig]
        rd = inputs.reads(ev, g)
        rec = Records(text, rd.pos, rd.end,
                      [rd.cigar_text(i) for i in range(len(rd.pos))],
                      [rd.seq_text(i) for i in range(len(rd.pos))])
        if inputs.mode == "vcf":
            out[ev.svid] = ref.vcf_row(rec, lines[ev.svid], ev.kind, ev.s,
                                       ev.e, ev.ins.decode())
        else:
            out[ev.svid] = ref.bed_row(rec, ev.contig, ev.kind, ev.s, ev.e,
                                       ev.svid)
    return out


def judge(cell, inputs, calls, seed: int):
    """(numbers compared with their limits, lines for stderr)."""
    detail: List[str] = []
    missing = 0
    for call in calls:
        want = {ev.svid for c in call.contigs for ev in inputs.events[c]}
        got = call.rows
        missing += len(want ^ set(got)) + sum(
            len(v) - 1 for v in got.values() if len(v) > 1)
    contigs = sorted({c for call in calls for c in call.contigs})
    events = sample(inputs, contigs, seed, int(cell.config["check_events"]))
    expected = reference_rows(inputs, events, Reference())
    wrong = compared = 0
    for call in calls:
        for ev in events:
            if ev.contig not in call.contigs:
                continue
            compared += 1
            got = call.rows.get(ev.svid, [None])[0]
            if got != expected[ev.svid]:
                wrong += 1
                if wrong <= 2:
                    detail.append(f"check: {ev.svid} differs\n  program:   "
                                  f"{str(got)[:600]}\n  reference: "
                                  f"{expected[ev.svid][:600]}")
    detail.append(f"check: {compared} rows of {len(events)} sampled events "
                  f"compared over {len(calls)} calls")
    numbers = {"rows_wrong": wrong, "rows_missing_or_extra": missing,
               "calls_failed": sum(c.rc != 0 for c in calls)}
    numbers = {k: {"value": v, "limit": LIMITS[k]} for k, v in
               numbers.items()}
    for k, v in numbers.items():
        detail.append(f"check {k} {v['value']} limit {v['limit']}")
    return numbers, detail


def control(cell, inputs, seed: int):
    """judge's (numbers, lines) for the control in the program's place:
    the reference with the configuration's control step (float32, or
    reads clipped at the reference offset without their CIGAR) writes
    every row of one call a contig, which judge compares as it does a
    run's calls."""
    kind = cell.config["control"]
    ref = Reference(precision="float32") if kind == "float32" else \
        Reference(clip="reference_offset")
    calls = []
    for contig in inputs.lengths:
        rows = reference_rows(inputs, inputs.events[contig], ref)
        calls.append(SimpleNamespace(contigs=[contig], rc=0, rows={
            k: [v] for k, v in rows.items()}))
    return judge(cell, inputs, calls, seed)
