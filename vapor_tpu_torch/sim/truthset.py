"""Truth-set simulation: spec-driven SV placement + genome mutation.

Modern, BioPython-free equivalent of the reference's simulation pair
(simulate/selectVariantChromosomes.py:17-58 and
generateVariantChromosomes.py:184-303): distribute an SV spec across
contigs weighted by length, place non-overlapping breakpoints with
buffers and blacklist avoidance, apply the edits (del / inv /
tan_dup / dis_dup / ins / del_inv / dup_inv) end-to-start so upstream
coordinates stay stable, optionally salt breakpoints with micro-indels,
and emit truth BED/VCF plus the mutated FASTA.

Used by the truth corpus (sim/corpus.py) and the scale fixture
(sim/scale.py) to measure sensitivity/specificity of the validator
against known SVs.  A copy of the JAX package's module: the same seed
draws the same random stream and places the same SVs.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..io.fasta import reverse_complement


@dataclass
class SVSpec:
    """One row of the simulation spec table."""
    svtype: str                  # del, inv, tan_dup, dis_dup, ins,
    #                              del_inv, dup_inv, dup_inv_ins,
    #                              del_dup, del_dup_inv
    size_range: Tuple[int, int]
    count: int
    dup_times: int = 2           # tan_dup copy count (reference: <= 50)


@dataclass
class PlacedSV:
    svtype: str
    chrom: str
    start0: int
    end0: int
    info: Dict = field(default_factory=dict)


DEFAULT_SPEC = [
    SVSpec("del", (100, 1000), 4),
    SVSpec("inv", (100, 1000), 4),
    SVSpec("tan_dup", (100, 600), 3),
    SVSpec("dis_dup", (100, 500), 2),
    SVSpec("ins", (100, 500), 3),
    SVSpec("del_inv", (100, 500), 2),
    SVSpec("dup_inv_ins", (100, 500), 2),
    SVSpec("del_dup", (300, 600), 2),
    SVSpec("del_dup_inv", (300, 600), 2),
]


def distribute_counts(spec: Sequence[SVSpec],
                      contig_lengths: Dict[str, int],
                      rng: random.Random) -> Dict[str, List[SVSpec]]:
    """Split spec counts across contigs weighted by length (~±10%,
    selectVariantChromosomes.py:28-45)."""
    total = sum(contig_lengths.values())
    out: Dict[str, List[SVSpec]] = {c: [] for c in contig_lengths}
    for s in spec:
        remaining = s.count
        items = list(contig_lengths.items())
        for i, (chrom, length) in enumerate(items):
            if i == len(items) - 1:
                n = remaining
            else:
                base = s.count * length / total
                n = max(0, min(remaining,
                               round(base * rng.uniform(0.9, 1.1))))
            remaining -= n
            if n > 0:
                out[chrom].append(SVSpec(s.svtype, s.size_range, n,
                                         s.dup_times))
    return out


def place_svs(contig_len: int, chrom: str, specs: Sequence[SVSpec],
              rng: random.Random, buffer: int = 3000,
              blacklist: Sequence[Tuple[int, int]] = ()) -> List[PlacedSV]:
    """Non-overlapping placements with inter-SV buffers and blacklist
    avoidance (generateVariantChromosomes.py:184-260)."""
    taken: List[Tuple[int, int]] = [tuple(b) for b in blacklist]

    def free(s: int, e: int) -> bool:
        return all(e + buffer <= bs or s - buffer >= be
                   for bs, be in taken)

    out: List[PlacedSV] = []
    for spec in specs:
        for _ in range(spec.count):
            for _attempt in range(200):
                size = rng.randint(*spec.size_range)
                s = rng.randint(buffer, contig_len - buffer - size)
                e = s + size
                extra_ok = True
                info: Dict = {}
                if spec.svtype in ("dis_dup", "dup_inv"):
                    lo = e + buffer // 2
                    hi = min(contig_len - buffer, e + 3 * buffer)
                    if hi <= lo:        # placed too close to the end
                        continue
                    ip = rng.randint(lo, hi)
                    extra_ok = free(ip, ip + 1)
                    info["insert_point"] = ip
                if spec.svtype == "dup_inv_ins":
                    # reference dup_inv_ins variants
                    # (generateVariantChromosomes.py:242-247):
                    # ab/aba^ inserts revcomp(a) after b; ab/b^ab
                    # inserts revcomp(b) before a
                    variant = rng.choice(["ab/aba^", "ab/b^ab"])
                    if variant == "ab/aba^":
                        lo = e + buffer // 2
                        hi = min(contig_len - buffer, e + 3 * buffer)
                    else:
                        lo = max(buffer, s - 3 * buffer)
                        hi = s - buffer // 2
                    if hi <= lo:        # placed too close to an edge
                        continue
                    ip = rng.randint(lo, hi)
                    extra_ok = free(ip, ip + 1)
                    info["insert_point"] = ip
                    info["variant"] = variant
                if spec.svtype in ("del_dup", "del_dup_inv"):
                    # three blocks a|b|c inside [s, e); the variant
                    # deletes one flank block and duplicates the other
                    # into its place (:248-263)
                    third = max(30, size // 3)
                    m1 = s + rng.randint(third - third // 4,
                                         third + third // 4)
                    m2 = e - rng.randint(third - third // 4,
                                         third + third // 4)
                    if m2 <= m1 + 10:
                        continue
                    info["blocks"] = (s, m1, m2, e)
                    if spec.svtype == "del_dup":
                        info["variant"] = rng.choice(
                            ["aba/abc", "cbc/abc"])
                    else:
                        info["variant"] = rng.choice(
                            ["aba^/abc", "c^bc/abc"])
                if spec.svtype == "tan_dup":
                    info["dup_times"] = spec.dup_times
                if free(s, e) and extra_ok:
                    taken.append((s, e))
                    if "insert_point" in info:
                        taken.append((info["insert_point"],
                                      info["insert_point"] + 1))
                    out.append(PlacedSV(spec.svtype, chrom, s, e, info))
                    break
    out.sort(key=lambda sv: sv.start0)
    return out


def apply_svs(ref: str, svs: Sequence[PlacedSV], rng: random.Random,
              micro_indel_rate: float = 0.12) -> str:
    """Mutate a contig: edits applied end -> start so coordinates stay
    valid (generateVariantChromosomes.py:278-298); breakpoints get
    micro-indels at ``micro_indel_rate`` (:264)."""
    edits: List[Tuple[int, int, str]] = []   # (start0, end0, replacement)
    for sv in svs:
        body = ref[sv.start0:sv.end0]
        sv_edits: List[Tuple[int, int, str]] = []
        if sv.svtype == "del":
            sv_edits.append((sv.start0, sv.end0, ""))
        elif sv.svtype == "inv":
            sv_edits.append((sv.start0, sv.end0,
                             reverse_complement(body)))
        elif sv.svtype == "tan_dup":
            times = sv.info.get("dup_times", 2)
            sv_edits.append((sv.start0, sv.end0, body * times))
        elif sv.svtype == "ins":
            ins = "".join(rng.choice("ACGT")
                          for _ in range(sv.end0 - sv.start0))
            sv.info["seq"] = ins
            sv_edits.append((sv.start0, sv.start0, ins))
        elif sv.svtype == "dis_dup":
            ip = sv.info["insert_point"]
            sv_edits.append((ip, ip, body))
        elif sv.svtype == "dup_inv":
            ip = sv.info["insert_point"]
            sv_edits.append((ip, ip, reverse_complement(body)))
        elif sv.svtype == "dup_inv_ins":
            # ab/aba^: revcomp(a) after b; ab/b^ab: revcomp(b) before a
            # (generateVariantChromosomes.py:242-247 — the duplicated
            # copy is the [start0, end0) block either way)
            ip = sv.info["insert_point"]
            sv_edits.append((ip, ip, reverse_complement(body)))
        elif sv.svtype in ("del_dup", "del_dup_inv"):
            # abc -> aba (delete c, copy of a in its place) or
            # abc -> cbc; del_dup_inv inverts the duplicated copy
            # (generateVariantChromosomes.py:248-263)
            s, m1, m2, e = sv.info["blocks"]
            variant = sv.info["variant"]
            a_body, c_body = ref[s:m1], ref[m2:e]
            if variant.startswith("aba"):       # delete c, dup a
                repl = a_body if variant == "aba/abc" else \
                    reverse_complement(a_body)
                sv_edits.append((m2, e, repl))
            else:                               # delete a, dup c
                repl = c_body if variant == "cbc/abc" else \
                    reverse_complement(c_body)
                sv_edits.append((s, m1, repl))
        elif sv.svtype == "del_inv":
            mid = sv.start0 + (sv.end0 - sv.start0) // 2
            sv.info["del_block"] = (sv.start0, mid)
            sv.info["inv_block"] = (mid, sv.end0)
            sv_edits.append((sv.start0, sv.end0,
                             reverse_complement(ref[mid:sv.end0])))
        else:
            raise ValueError(sv.svtype)
        # (position, length delta) pairs let callers map reference ->
        # donor coordinates without re-deriving per-type semantics
        sv.info["edits"] = [(s0, len(repl) - (e0 - s0))
                            for s0, e0, repl in sv_edits]
        edits.extend(sv_edits)
    donor = ref
    for s, e, repl in sorted(edits, key=lambda t: -t[0]):
        if rng.random() < micro_indel_rate:
            repl = rng.choice("ACGT") + repl
        donor = donor[:s] + repl + donor[e:]
    return donor


def write_truth_bed(path: str, svs: Sequence[PlacedSV]) -> None:
    label = {"del": "DEL", "inv": "INV", "tan_dup": "DUP",
             "dis_dup": "DISDUP", "ins": "INS", "del_inv": "DEL_INV",
             "dup_inv": "DUP_INV", "dup_inv_ins": "DUP_INV",
             "del_dup": "DEL_DUP", "del_dup_inv": "DEL_DUP_INV"}
    with open(path, "w") as fo:
        for i, sv in enumerate(svs):
            fo.write(f"{sv.chrom}\t{sv.start0}\t{sv.end0}\tsv{i}\t"
                     f"{label[sv.svtype]}\n")


def write_truth_vcf(path: str, svs: Sequence[PlacedSV],
                    contig_lengths: Dict[str, int]) -> None:
    lines = ["##fileformat=VCFv4.2"]
    for c, ln in contig_lengths.items():
        lines.append(f"##contig=<ID={c},length={ln}>")
    lines += ['##INFO=<ID=END,Number=1,Type=Integer,Description="E">',
              '##INFO=<ID=SVTYPE,Number=1,Type=String,Description="T">',
              "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS"]
    for i, sv in enumerate(svs):
        if sv.svtype == "del":
            info = f"SVTYPE=DEL;END={sv.end0}"
        elif sv.svtype == "inv":
            info = f"SVTYPE=INV;END={sv.end0}"
        elif sv.svtype == "tan_dup":
            info = f"SVTYPE=DUP;END={sv.end0}"
        elif sv.svtype == "ins":
            seq = sv.info.get("seq", "")
            info = (f"SVTYPE=INS;END={sv.start0 + 1};"
                    f"SVLEN={len(seq)};SEQ={seq}")
        elif sv.svtype == "dis_dup":
            info = (f"SVTYPE=disdup;END={sv.end0};"
                    f"insert_point={sv.chrom}:{sv.info['insert_point']}")
        elif sv.svtype == "dup_inv":
            info = (f"SVTYPE=dup_inv;END={sv.end0};"
                    f"insert_point={sv.chrom}:{sv.info['insert_point']}")
        elif sv.svtype == "dup_inv_ins":
            # reference truth-set encoding: SVTYPE=dup_inv + Other=
            # (Structural_Variants_het/chr10_svBreakpoints.vcf)
            ip = sv.info["insert_point"]
            variant = sv.info["variant"]
            bps = (sv.start0, sv.end0, ip) if variant == "ab/aba^" \
                else (ip, sv.start0, sv.end0)
            other = f"ab/ab_{variant}_{sv.chrom}:" + \
                ":".join(str(b) for b in bps)
            info = (f"SVTYPE=dup_inv;END={sv.end0};"
                    f"insert_point={sv.chrom}:{ip};Other={other}")
        elif sv.svtype in ("del_dup", "del_dup_inv"):
            s, m1, m2, e = sv.info["blocks"]
            variant = sv.info["variant"]
            if variant.startswith("aba"):   # delete c, duplicate a
                del_blk, dup_blk = (m2, e), (s, m1)
                dup_pos = m2
            else:                           # delete a, duplicate c
                del_blk, dup_blk = (s, m1), (m2, e)
                dup_pos = s
            dup_key = "dup" if sv.svtype == "del_dup" else "dup_inv"
            other = (f"abc/abc_{variant}_{sv.chrom}:{s}:{m1}:{m2}:{e}")
            info = (f"SVTYPE={sv.svtype};END={e};"
                    f"del={sv.chrom}:{del_blk[0]}-{del_blk[1]};"
                    f"{dup_key}={sv.chrom}:{dup_blk[0]}-{dup_blk[1]}")
            if sv.svtype == "del_dup_inv":
                info += f";insert_point={sv.chrom}:{dup_pos}"
            info += f";Other={other}"
        elif sv.svtype == "del_inv":
            ds, de = sv.info["del_block"]
            vs, ve = sv.info["inv_block"]
            info = (f"SVTYPE=del_inv;END={sv.end0};"
                    f"del={sv.chrom}:{ds}-{de};inv={sv.chrom}:{vs}-{ve}")
        else:
            continue
        lines.append(f"{sv.chrom}\t{sv.start0 + 1}\tsv{i}\tN\t<SV>\t99\t"
                     f"PASS\t{info}\tGT\t0/1")
    with open(path, "w") as fo:
        fo.write("\n".join(lines) + "\n")
