"""Indexed FASTA access with `samtools faidx`-compatible region semantics.

The reference shells out to ``samtools faidx ref chrom:start-end`` for every
sequence fetch (Simple_function.pyx:1203-1217).  We read the ``.fai`` index
directly and memory-seek into the FASTA, reproducing faidx behavior:

* regions are 1-based, inclusive on both ends;
* a start below 1 is clamped to 1, an end beyond the contig is clamped;
* soft-masked lowercase bases are preserved;
* an empty/invalid region yields an empty string.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, List, Tuple

_COMPLEMENT = str.maketrans("ACGTNacgtn", "TGCANtgcan")


def complement(seq: str) -> str:
    """Per-base complement, keeping case; non-ACGTN bases are dropped.

    Mirrors the reference's ``complementary`` (pyx:471-478), which silently
    drops characters outside ACGTNacgtn.
    """
    return "".join(
        c.translate(_COMPLEMENT) for c in seq if c in "ACGTNacgtn"
    )


def reverse_complement(seq: str) -> str:
    """reverse(complementary(seq)) as composed by the reference (pyx:1217)."""
    return complement(seq)[::-1]


class FastaFile:
    """Random access to an indexed FASTA via its ``.fai``."""

    def __init__(self, path: str):
        self.path = path
        fai = path + ".fai"
        if not os.path.exists(fai):
            build_fai(path)
        self._index: Dict[str, Tuple[int, int, int, int]] = {}
        self._order: List[str] = []
        with open(fai) as fh:
            for line in fh:
                parts = line.rstrip("\n").split("\t")
                if len(parts) < 5:
                    continue
                name, length, offset, linebases, linewidth = parts[:5]
                self._index[name] = (
                    int(length), int(offset), int(linebases), int(linewidth))
                self._order.append(name)
        self._fh = open(path, "rb")
        self._lock = threading.Lock()

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def references(self) -> List[str]:
        """Contig names in .fai order (pyx:356-363 ``chromos_readin``)."""
        return list(self._order)

    def contig_length(self, chrom: str) -> int:
        return self._index[chrom][0]

    def fetch(self, chrom: str, start: int, end: int,
              revcomp: bool = False) -> str:
        """Fetch ``chrom:start-end`` (1-based inclusive), faidx-style.

        ``revcomp=True`` returns the reverse complement, matching
        ``ref_seq_readin(..., 'TRUE')`` (pyx:1214-1217).
        """
        if chrom not in self._index:
            return ""
        length, offset, linebases, linewidth = self._index[chrom]
        start = int(start)
        end = int(end)
        if start < 1:
            start = 1
        if end > length:
            end = length
        if end < start:
            return ""
        start0 = start - 1
        # byte offset of base `start0` accounting for line terminators
        first = offset + (start0 // linebases) * linewidth + (start0 % linebases)
        last_excl = end  # 0-based exclusive == 1-based inclusive end
        last = offset + ((last_excl - 1) // linebases) * linewidth + \
            ((last_excl - 1) % linebases) + 1
        with self._lock:
            self._fh.seek(first)
            raw = self._fh.read(last - first)
        seq = raw.replace(b"\n", b"").replace(b"\r", b"").decode("ascii")
        if revcomp:
            return reverse_complement(seq)
        return seq


def build_fai(path: str) -> None:
    """Create a ``.fai`` for a well-formed FASTA (uniform line widths)."""
    entries = []
    with open(path, "rb") as fh:
        name = None
        length = 0
        offset = 0
        linebases = 0
        linewidth = 0
        while True:
            line_start = fh.tell()
            line = fh.readline()
            if not line:
                break
            if line.startswith(b">"):
                if name is not None:
                    entries.append((name, length, offset, linebases, linewidth))
                name = line[1:].split()[0].decode("ascii")
                length = 0
                offset = fh.tell()
                linebases = 0
                linewidth = 0
            else:
                stripped = line.rstrip(b"\r\n")
                if linebases == 0:
                    linebases = len(stripped)
                    linewidth = len(line)
                length += len(stripped)
        if name is not None:
            entries.append((name, length, offset, linebases, linewidth))
    with open(path + ".fai", "w") as out:
        for name, length, offset, linebases, linewidth in entries:
            out.write(f"{name}\t{length}\t{offset}\t{linebases}\t{linewidth}\n")


def write_fasta(path: str, contigs: Dict[str, str], width: int = 60) -> None:
    """Write a FASTA + .fai (test/simulation helper)."""
    with open(path, "w") as out:
        for name, seq in contigs.items():
            out.write(f">{name}\n")
            for i in range(0, len(seq), width):
                out.write(seq[i:i + width] + "\n")
    build_fai(path)
