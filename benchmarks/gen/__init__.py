"""Frozen generator of a cell's inputs: genome, call set and long reads.

It imports nothing of the program: later changes to the program's own
simulators or readers cannot move what the benchmark feeds it.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from . import formats
from .layout import (Event, Shape, contig_events, contig_names,
                     event_reads, genome, make_layout)


@dataclass
class CellInputs:
    """Files of one run and the records the reference draws again."""
    root: str
    mode: str                          # "vcf" or "bed"
    fasta: str
    bam: str
    calls: str                         # the whole call set
    per_contig: Dict[str, str]         # contig -> its call set
    layout: List[Shape]
    events: Dict[str, List[Event]]     # contig -> events in file order
    lengths: Dict[str, int]
    seed: int
    error: Dict = field(default_factory=dict)

    def genome(self, contig: str) -> np.ndarray:
        names = list(self.lengths)
        return genome(self.seed, names.index(contig), self.lengths[contig])

    def reads(self, ev: Event, g: np.ndarray = None):
        """The event's reads, drawn again from the seed."""
        names = list(self.lengths)
        ci = names.index(ev.contig)
        g = self.genome(ev.contig) if g is None else g
        rank = self.events[ev.contig].index(ev)
        return event_reads(ev, self.layout[ev.shape_id], g, self.seed, ci,
                           rank, self.error)


def build(root: str, config: Dict, traffic: Dict, seed: int,
          threads: int = 4) -> CellInputs:
    """Writes ref.fa(.fai), reads.bam(.bai), the call set and one call
    set per contig under `root`."""
    os.makedirs(root, exist_ok=True)
    mode = config["mode"]
    layout = make_layout(config, traffic)
    lmax = int(traffic["read_length"]["max"])
    names = contig_names(traffic)
    events: Dict[str, List[Event]] = {}
    lengths: Dict[str, int] = {}
    for ci, name in enumerate(names):
        events[name], lengths[name] = contig_events(layout, seed, ci, name,
                                                    lmax)
    inputs = CellInputs(root, mode, os.path.join(root, "ref.fa"),
                        os.path.join(root, "reads.bam"),
                        os.path.join(root, f"calls.{mode}"), {}, layout,
                        events, lengths, seed, dict(traffic["error"]))
    formats.write_fasta(inputs.fasta,
                        [(n, inputs.genome(n)) for n in names])

    def stream():
        for ci, name in enumerate(names):
            g = inputs.genome(name)
            for rank, ev in enumerate(events[name]):
                yield ci, event_reads(ev, layout[ev.shape_id], g, seed, ci,
                                      rank, inputs.error)

    formats.write_bam(inputs.bam, list(lengths.items()), stream(), threads)

    def write(path, contigs):
        evs = [ev for n in contigs for ev in events[n]]
        if mode == "vcf":
            formats.write_vcf(path, [(n, lengths[n]) for n in contigs], evs)
        else:
            formats.write_bed(path, evs)
    write(inputs.calls, names)
    for n in names:
        inputs.per_contig[n] = os.path.join(root, f"calls.{n}.{mode}")
        write(inputs.per_contig[n], [n])
    return inputs
