"""VaPoR's validation of one call, from its records to its output row.

Frozen copies of the port's read gather (io/cigar.py, io/reads.py), its
faidx fetch (io/fasta.py), the window refiner (engine/window.py), the
validators of DEL, INS, INV and tandem DUP (validators.py), the
genotyper (stats/genotype.py) and the row formats of the `.vapor` TSV
and of the annotated VCF (writers/).  ``precision`` and ``clip`` select
the control: float32 for every non-integer quantity, or reads clipped
at their reference offset without their CIGAR.
"""
from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Sequence

import numpy as np

from .cluster import xmeans_cluster_pairs
from .oracle import Scorers, dot_arrays

DEFAULT_FLANK = 500
MAX_SV_TEST = 10000
IDEAL_READS = 20
NUM_READS_CFF = 3
REGION_QC_CFF = 0.4
MIN_SV_SPAN = 50
INS_LONG_SEQ = 5000
READ_N_CFF = 0.1
_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")
_COMPLEMENT = str.maketrans("ACGTNacgtn", "TGCANtgcan")


def reverse_complement(seq: str) -> str:
    return "".join(c.translate(_COMPLEMENT) for c in seq
                   if c in "ACGTNacgtn")[::-1]


def flank_length(s: int, e: int) -> int:
    span = e - s
    return span if span < 500 else 500


def cigar_align_start(cigar: str, pos1: int, start1: int):
    read_rec, align_rec, last_op = 0, pos1, ("", "")
    for m in _CIGAR_RE.finditer(cigar):
        n, op = int(m.group(1)), m.group(2)
        if op == "S":
            read_rec += n
        elif op in ("M", "="):
            read_rec += n
            align_rec += n
        elif op == "D":
            align_rec += n
        elif op == "I":
            read_rec += n
        last_op = (n, op)
        if align_rec > start1 - 1:
            break
    start_dis = align_rec - start1
    if last_op[1] in ("M", "="):
        return read_rec - start_dis, 0
    return read_rec, start_dis


def subsample(reads: List[List], ideal: int = IDEAL_READS) -> List[List]:
    if len(reads) <= ideal:
        return reads
    groups: Dict[int, List[List]] = {}
    for r in reads:
        groups.setdefault(r[1], []).append(r)
    out: List[List] = []
    for key in sorted(groups):
        if len(out) < ideal:
            out += groups[key]
    return out[:ideal]


def refine_window(seq: str) -> Optional[int]:
    """window_size_refine (pyx:2030-2046) with the repeat QC."""
    seq = seq.replace("X", "")
    if seq.count("N") + seq.count("n") > 100:
        return None
    window = 10
    ii, jj, ww, _, _ = dot_arrays(window, seq, seq)
    if ww.sum() == 0:
        return None
    qc = _repeat_qc(ii, jj, ww)
    while window <= 30:
        if qc[0] > REGION_QC_CFF or sum(qc[1]) / len(seq) < 0.3:
            break
        window += 10
        ii, jj, ww, _, _ = dot_arrays(window, seq, seq)
        qc = _repeat_qc(ii, jj, ww)
    return window


def _repeat_qc(ii, jj, ww):
    total = int(ww.sum())
    diag = int(ww[ii == jj].sum()) if ii.size else 0
    below = ii > jj
    frac_below = int(ww[below].sum()) / total if total else 0.0
    if total > 0 and 0.1 < frac_below < 0.5:
        xs = np.repeat(ii[below], ww[below]).tolist()
        ys = np.repeat(jj[below], ww[below]).tolist()
        sizes = [math.sqrt((max(cx) - min(cx)) * (max(cy) - min(cy)))
                 for cx, cy in xmeans_cluster_pairs(xs, ys, 0)]
    else:
        sizes = [0.0]
    return (diag / total if total else 0.0, sizes)


class Records:
    """One contig's genome and the BAM records the reference may read."""

    def __init__(self, genome: str, pos, end, cigars: Sequence[str],
                 seqs: Sequence[str]):
        self.genome = genome
        self.pos, self.end = np.asarray(pos), np.asarray(end)
        self.cigars, self.seqs = list(cigars), list(seqs)

    def fetch(self, start: int, end: int, revcomp: bool = False) -> str:
        """faidx chrom:start-end, 1-based inclusive, clamped."""
        start, end = max(int(start), 1), min(int(end), len(self.genome))
        if end < start:
            return ""
        seq = self.genome[start - 1:end]
        return reverse_complement(seq) if revcomp else seq

    def overlapping(self, start1: int, end1: int) -> List[int]:
        """Records overlapping start1-end1 in file order (htslib)."""
        beg0, end0 = max(0, start1 - 1), end1
        return np.flatnonzero((self.pos < end0) & (self.end > beg0)
                              ).tolist()


class Reference:
    """Rows of one call set, as VaPoR's CLI writes them."""

    def __init__(self, precision: str = "float64", clip: str = "cigar"):
        self.ft = {"float64": np.float64, "float32": np.float32}[precision]
        self.clip = clip
        self.scorers = Scorers(self.ft)

    # -- read gather ------------------------------------------------------

    def _clip(self, seq, cigar, pos1, start1, end1, flank):
        if not pos1 < start1 + 1:
            return None
        if self.clip == "cigar":
            align_start, miss = cigar_align_start(cigar, pos1, start1)
        else:
            align_start, miss = start1 - pos1, 0
        if miss > flank / 2:
            return None
        target = seq[align_start:]
        want = end1 - start1 - miss
        return [target[:want], miss] if len(target) > want else None

    def reads(self, rec: Records, start1: int, end1: int, flank: int):
        out = []
        for i in rec.overlapping(start1, end1):
            c = self._clip(rec.seqs[i], rec.cigars[i], int(rec.pos[i]) + 1,
                           start1, end1, flank)
            if c is not None:
                out.append(c)
        return subsample(out)

    # -- scoring ----------------------------------------------------------

    def _ratio(self, s) -> float:
        ft = self.ft
        return ft(1) - ft(s[1]) / ft(s[0])

    def _accumulate(self, scorer, ref_seq, alt_seq, reads, w):
        fn = getattr(self.scorers, scorer)
        out = []
        for r in reads:
            s = fn(ref_seq, alt_seq, r[0], r[1], w)
            if 0 not in s:
                out.append(self._ratio(s))
        return out

    def validate_del(self, rec: Records, s: int, e: int) -> List:
        f = flank_length(s, e)
        if e - s < MAX_SV_TEST:
            reads = self.reads(rec, s - f, s + f, f)
            if len(reads) <= NUM_READS_CFF:
                return []
            ref_seq = rec.fetch(s - f, e + f)
            w = refine_window(ref_seq)
            if w is None:
                return []
            alt_seq = ref_seq[:f] + ref_seq[-f:]
            scores = []
            for r in reads:
                a = self.scorers.abs_dis_m1b(ref_seq, alt_seq, r[0], r[1], w)
                b = self.scorers.within_10perc_m1b(ref_seq, alt_seq, r[0],
                                                   r[1], w)
                if 0 not in a and 0 not in b:
                    scores.append(min(self._ratio(a), self._ratio(b)))
                elif 0 not in a:
                    scores.append(self._ratio(a))
                elif 0 not in b:
                    scores.append(self._ratio(b))
            return scores
        reads = self.reads(rec, s - f, s + f, f)
        if len(reads) <= NUM_READS_CFF:
            return []
        ref_seq = rec.fetch(s - f, s + f)
        if refine_window(ref_seq) is None:
            return []
        alt_seq = rec.fetch(s - f, s) + rec.fetch(e, e + f)
        w = refine_window(alt_seq)
        if w is None:
            return []
        return self._accumulate("within_10perc_m1b", ref_seq, alt_seq,
                                reads, w)

    def validate_inv(self, rec: Records, s: int, e: int) -> List:
        f = flank_length(s, e)
        if e - s < MAX_SV_TEST:
            ref_seq = rec.fetch(s - f, e + f)
            if refine_window(ref_seq) is not None:
                alt_seq = ref_seq[:f] + \
                    reverse_complement(ref_seq[f:-f]) + ref_seq[-f:]
                w = refine_window(alt_seq)
                if w is not None:
                    reads = self.reads(rec, s - f, e + f, f)
                    if len(reads) > NUM_READS_CFF:
                        return self._accumulate("abs_dis_m1b", ref_seq,
                                                alt_seq, reads, w)
        ref_seq = rec.fetch(s - f, s + f)
        if refine_window(ref_seq) is None:
            return []
        alt_seq = ref_seq[:f] + rec.fetch(e - f, e, revcomp=True)
        w = refine_window(alt_seq)
        if w is None:
            return []
        reads = self.reads(rec, s - f, s + f, f)
        if len(reads) <= NUM_READS_CFF:
            return []
        return self._accumulate("within_10perc_m1b", ref_seq, alt_seq,
                                reads, w)

    def validate_tandup(self, rec: Records, s: int, e: int) -> List:
        f = flank_length(s, e)
        if e - s < MAX_SV_TEST:
            ref_seq = rec.fetch(s - f, e + f)
            if refine_window(ref_seq) is not None:
                body = ref_seq[f:-f]
                alt_seq = ref_seq[:f] + body + body + ref_seq[-f:]
                w = refine_window(alt_seq)
                if w is not None:
                    reads = self.reads(rec, s - f, s + 2 * (e - s) + f, f)
                    if len(reads) > NUM_READS_CFF:
                        return self._accumulate("redefine_diagonal",
                                                ref_seq, alt_seq, reads, w)
        ref_seq = rec.fetch(e - f, e + f)
        if refine_window(ref_seq) is None:
            return []
        alt_seq = rec.fetch(e - f, e) + rec.fetch(s, s + f)
        w = refine_window(alt_seq)
        if w is None:
            return []
        reads = self.reads(rec, e - f, e + f, f)
        if len(reads) <= NUM_READS_CFF:
            return []
        return self._accumulate("within_10perc_m1b", ref_seq, alt_seq,
                                reads, w)

    def validate_ins(self, rec: Records, pos: int, ins_seq: str) -> List:
        f = DEFAULT_FLANK if len(ins_seq) > DEFAULT_FLANK else len(ins_seq)
        reads = self.reads(rec, pos - f, pos + len(ins_seq) + f, f)
        if len(reads) <= NUM_READS_CFF:
            return []
        if len(ins_seq) < INS_LONG_SEQ:
            ref_seq = rec.fetch(pos - f, pos + f + len(ins_seq))
            w = refine_window(ref_seq + ins_seq)
        else:
            ref_seq = rec.fetch(pos - f, pos + f)
            w = refine_window(ref_seq)
        if w is None:
            return []
        alt_seq = rec.fetch(pos - f, pos) + ins_seq + rec.fetch(pos, pos + f)
        evaluable = [r for r in reads if (r[0].count("N") + r[0].count("n"))
                     / float(len(r[0])) < READ_N_CFF]
        return self._accumulate("abs_dis_m1b", ref_seq, alt_seq, evaluable,
                                w)

    # -- rows -------------------------------------------------------------

    @staticmethod
    def _genotype(gs, rec_text: str):
        read_scores = [float(x) for x in rec_text.split(",")]
        k = len(read_scores)
        low = len([x for x in read_scores if not x > 0])

        def loglik(g):
            out = -k * np.log(2)
            for _ in range(low):
                out += np.log((2 - g) * 0.05 + g * (1 - 0.05))
            for _ in range(k - low):
                out += np.log((2 - g) * (1 - 0.05) + g * 0.05)
            return out
        gt_score = [loglik(2), loglik(1), loglik(0)]
        top = max(gt_score)
        ori = [np.exp(x - top) for x in gt_score]
        norm = [x / sum(ori) for x in ori]
        with np.errstate(divide="ignore"):
            gq = -np.log(np.median(norm)) / np.log(10)
        gt = ["0/0", "0/1", "1/1"][gt_score.index(top)]
        if gt == "0/0" and gs > 0.15:
            gt = "0/1"
        return gt, gq

    def _fields(self, scores) -> List[str]:
        """[QS, GS, GT, GQ, Rec] as the `.vapor` TSV prints them."""
        if not len(scores):
            return ["NA"] * 5
        pos = [x for x in scores if float(x) > 0]
        neg = [x for x in scores if not float(x) > 0]
        gs = float(len(pos)) / float(len(pos) + len(neg))
        qs = np.mean(pos) if pos else 0
        rec = ",".join(str(round(float(x), 2)) for x in scores)
        gt, gq = self._genotype(gs, rec)
        return [str(qs), str(gs), gt, str(gq), rec]

    def scores(self, rec: Records, kind: str, s: int, e: int,
               ins: str = "", vcf: bool = False) -> List:
        if kind == "DEL":
            if vcf and e - s < MIN_SV_SPAN:
                return []
            return self.validate_del(rec, s, e)
        if kind == "INV":
            return self.validate_inv(rec, s, e)
        if kind == "DUP":
            return self.validate_tandup(rec, s, e)
        if kind == "INS":
            return self.validate_ins(rec, s, ins)
        raise ValueError(kind)

    def bed_row(self, rec: Records, chrom: str, kind: str, s: int, e: int,
                svid: str) -> str:
        label = "TANDUP" if kind == "DUP" else kind
        fields = self._fields(self.scores(rec, kind, s, e))
        return "\t".join([chrom, str(s), str(e), label, svid] + fields)

    def vcf_row(self, rec: Records, line: str, kind: str, s: int, e: int,
                ins: str = "") -> str:
        """The call's line of the annotated VCF that vcf mode writes."""
        pin = line.split()
        qs, gs, gt, gq, rtext = self._fields(
            self.scores(rec, kind, s, e, ins, vcf=True))
        gs = round(float(gs), 2) if gs != "NA" else gs
        gq = round(float(gq), 2) if gq != "NA" else gq
        pin[7] += (f";VaPor_GS={gs};VaPor_GT={gt}"
                   f";VaPor_GQ={gq};VaPor_REC={rtext}")
        return "\t".join(pin)
