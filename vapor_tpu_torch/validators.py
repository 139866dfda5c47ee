"""Per-SV-type validators: whole-event scoring with junction fallbacks.

Each method mirrors one reference validator's control flow — the gate
*order* (reads-before-window vs window-before-reads, fall-through
conditions, per-type scorer choice) is behavior, so it is preserved
type by type:

  DEL     vapor_simple_del_Vapor        pyx:1701-1745
  INV     vapor_simple_inv_Vapor        pyx:1895-1933
  TANDUP  vapor_simple_tandup_Vapor     pyx:1747-1784
  INS     vapor_simple_ins_Vapor        pyx:1856-1893
  DISDUP  vapor_simple_disdup_Vapor     pyx:1786-1854
  DEL_INV vapor_del_inv_Vapor           pyx:1557-1593 (+ long, 1671-1691)
  DUP_INV vapor_dup_inv_VapoR           pyx:1595-1669
  Other   vapor_CANNOT_CLASSIFY_VapoR   pyx:1490-1555

Every validator is written once, as a generator (``validate_*_gen``)
that yields zero-arg finishers wherever a device round-trip would
block; the public ``validate_*`` methods drain the generator (the
original blocking semantics), while the CLI pipeline overlaps many
generators on one thread (utils/coro.py).

Known reference bugs fixed here (documented divergences):
* pyx:1585/1591-1592 call validators with a stale 4-argument signature
  and would raise TypeError; we dispatch with the live signature.
* DISDUP with the insert point strictly inside the duplicated block has
  no alt structure in the reference (NameError, pyx:1803-1804); we
  return no scores (event degrades to NA).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

from .config import DEFAULT_CONFIG, VaporConfig
from .engine.fused import FusedBackend
from .engine.kernel import V1Backend
from .engine.scoring import get_backend
from .engine.window import window_size_refine
from .engine.window_device import DeviceWindowRefiner
from .grammar.letters import (block_around_check, bp_to_chr_hash,
                              block_subsplot, flank_length_calculate,
                              letter_split)
from .io.fasta import FastaFile, reverse_complement
from .io.reads import collect_event_reads
from .utils import trace
from .utils.coro import drain


def _unique(seq: Sequence) -> List:
    out = []
    for item in seq:
        if item not in out:
            out.append(item)
    return out


class ValidatorContext:
    """Shared state for one run: reference FASTA, BAM, backend, figures."""

    def __init__(self, ref_path: str, bam_in: str, backend: str = "torch",
                 device=None, config: VaporConfig = DEFAULT_CONFIG,
                 figures: bool = True):
        self.fasta = FastaFile(ref_path)
        self.bam_in = bam_in
        self.backend = get_backend(backend, device)
        self.cfg = config
        # the torch backends refine on their device (in the batched
        # backend's flushes where it batches); numpy refines on the host
        self._refiner = None
        if isinstance(self.backend, (FusedBackend, V1Backend)):
            self._refiner = DeviceWindowRefiner(
                config.region_qc_cff,
                submit=getattr(self.backend, "submit_selfstats", None),
                device=self.backend.device)
        self.figures = figures
        # BAM ingest prefetch: decode the BGZF stream on a background
        # thread while the worklist parses / first haplotypes build
        import threading

        def _warm():
            try:
                from .io.reads import resolve_bam_inputs, _open_bam
                for path in resolve_bam_inputs(bam_in):
                    _open_bam(path)
            except Exception:
                pass

        self._prefetch = threading.Thread(target=_warm, daemon=True)
        self._prefetch.start()

    # -- primitives -------------------------------------------------------

    def fetch(self, chrom, start, end, revcomp: bool = False) -> str:
        with trace.span("fetch"):
            return self.fasta.fetch(chrom, int(start), int(end),
                                    revcomp=revcomp)

    def reads(self, chrom, start, end, flank) -> List[List]:
        """Window read gather; region is [start+... ] 1-based via the
        reference's ``samtools view chrom:start-end`` call shape."""
        with trace.span("reads"):
            return collect_event_reads(
                self.bam_in, str(chrom), int(start), int(end), flank,
                self.cfg.ideal_read_list_length)

    def refine(self, seq: str) -> Optional[int]:
        return drain(self._refine_gen(seq))

    def _refine_gen(self, seq: str):
        if self._refiner is not None:
            return (yield from self._refiner.refine_gen(seq))
        w, _ = window_size_refine(seq, self.cfg.region_qc_cff)
        return w

    def _score(self, scorer: str, ref_seq: str, alt_seq: str,
               reads: List[List], window: int) -> List[List[float]]:
        return self._score_async(scorer, ref_seq, alt_seq, reads,
                                 window)()

    def _score_async(self, scorer: str, ref_seq: str, alt_seq: str,
                     reads: List[List], window: int):
        """Dispatch a score batch; returns the zero-arg finisher."""
        if hasattr(self.backend, "score_batch_async"):
            return self.backend.score_batch_async(scorer, ref_seq,
                                                  alt_seq, reads, window)
        out = self.backend.score_batch(scorer, ref_seq, alt_seq, reads,
                                       window)
        return lambda: out

    def _accumulate(self, raw_scores, reads, scores, state,
                    nan_guard: bool = False) -> None:
        """score = 1 - alt/ref for evaluable reads; track best read."""
        for s, read in zip(raw_scores, reads):
            if 0 in s:
                continue
            if nan_guard and (math.isnan(s[0]) or math.isnan(s[1])):
                continue
            scores.append(1 - float(s[1]) / float(s[0]))
            if scores[-1] == max(scores):
                state["best"] = read
        return None

    def _figure(self, scores, state, window, ref_seq, alt_seq,
                fig_name: str) -> None:
        if not self.figures:
            return
        best = state.get("best", "")
        if best == "" or best == []:
            return
        from .figures import make_event_figure
        make_event_figure(best, window, ref_seq, alt_seq, fig_name)

    # -- validators -------------------------------------------------------
    # (public blocking forms; each drains its generator twin below)

    def validate_del(self, *a, **kw) -> List[float]:
        return drain(self.validate_del_gen(*a, **kw))

    def validate_inv(self, *a, **kw) -> List[float]:
        return drain(self.validate_inv_gen(*a, **kw))

    def validate_tandup(self, *a, **kw) -> List[float]:
        return drain(self.validate_tandup_gen(*a, **kw))

    def validate_ins(self, *a, **kw) -> List[float]:
        return drain(self.validate_ins_gen(*a, **kw))

    def validate_disdup(self, *a, **kw) -> List[float]:
        return drain(self.validate_disdup_gen(*a, **kw))

    def validate_dup_inv(self, *a, **kw) -> List[float]:
        return drain(self.validate_dup_inv_gen(*a, **kw))

    def validate_del_inv(self, *a, **kw) -> List[float]:
        return drain(self.validate_del_inv_gen(*a, **kw))

    def validate_long_del_inv(self, *a, **kw) -> List[float]:
        return drain(self.validate_long_del_inv_gen(*a, **kw))

    def validate_complex(self, *a, **kw) -> List[float]:
        return drain(self.validate_complex_gen(*a, **kw))

    def validate_del_gen(self, num_reads_cff: int, sv_info: Sequence,
                         fig_name: str = ""):
        """pyx:1701-1745."""
        chrom, s, e = sv_info[0], int(sv_info[1]), int(sv_info[2])
        flank = flank_length_calculate([chrom, s, e])
        scores: List[float] = []
        state: Dict = {}
        if e - s < self.cfg.max_sv_test:
            reads = self.reads(chrom, s - flank, s + flank, flank)
            if len(reads) > num_reads_cff:
                ref_seq = self.fetch(chrom, s - flank, e + flank)
                w = yield from self._refine_gen(ref_seq)
                if w is not None:
                    alt_seq = ref_seq[:flank] + ref_seq[-flank:]
                    if hasattr(self.backend, "score_del_batch_async"):
                        s1, s2 = yield self.backend.score_del_batch_async(
                            ref_seq, alt_seq, reads, w)
                    elif hasattr(self.backend, "score_del_batch"):
                        s1, s2 = self.backend.score_del_batch(
                            ref_seq, alt_seq, reads, w)
                    else:
                        s1 = yield self._score_async(
                            "abs_dis_m1b", ref_seq, alt_seq, reads, w)
                        s2 = yield self._score_async(
                            "within_10perc_m1b", ref_seq, alt_seq,
                            reads, w)
                    for a, b, read in zip(s1, s2, reads):
                        if 0 not in a and 0 not in b:
                            scores.append(min(1 - float(a[1]) / float(a[0]),
                                              1 - float(b[1]) / float(b[0])))
                        elif 0 not in a:
                            scores.append(1 - float(a[1]) / float(a[0]))
                        elif 0 not in b:
                            scores.append(1 - float(b[1]) / float(b[0]))
                        else:
                            continue
                        if scores[-1] == max(scores):
                            state["best"] = read
                    self._figure(scores, state, w, ref_seq, alt_seq,
                                 fig_name)
        else:
            reads = self.reads(chrom, s - flank, s + flank, flank)
            if len(reads) > num_reads_cff:
                ref_seq = self.fetch(chrom, s - flank, s + flank)
                if (yield from self._refine_gen(ref_seq)) is not None:
                    alt_seq = self.fetch(chrom, s - flank, s) + \
                        self.fetch(chrom, e, e + flank)
                    w = yield from self._refine_gen(alt_seq)
                    if w is not None:
                        trace.count("validate.junction")
                        raw = yield self._score_async(
                            "within_10perc_m1b", ref_seq, alt_seq,
                            reads, w)
                        self._accumulate(raw, reads, scores, state)
                        self._figure(scores, state, w, ref_seq, alt_seq,
                                     fig_name)
        return scores

    def validate_inv_gen(self, num_reads_cff: int, sv_info: Sequence,
                         fig_name: str = ""):
        """pyx:1895-1933."""
        chrom, s, e = sv_info[0], int(sv_info[1]), int(sv_info[2])
        flank = flank_length_calculate([chrom, s, e])
        scores: List[float] = []
        state: Dict = {}
        if e - s < self.cfg.max_sv_test:
            ref_seq = self.fetch(chrom, s - flank, e + flank)
            if (yield from self._refine_gen(ref_seq)) is not None:
                alt_seq = ref_seq[:flank] + \
                    reverse_complement(ref_seq[flank:-flank]) + \
                    ref_seq[-flank:]
                w = yield from self._refine_gen(alt_seq)
                if w is not None:
                    reads = self.reads(chrom, s - flank, e + flank, flank)
                    if len(reads) > num_reads_cff:
                        raw = yield self._score_async(
                            "abs_dis_m1b", ref_seq, alt_seq, reads, w)
                        self._accumulate(raw, reads, scores, state)
                        self._figure(scores, state, w, ref_seq, alt_seq,
                                     fig_name)
                        return scores
        # junction fallback (pyx:1918-1933)
        ref_seq = self.fetch(chrom, s - flank, s + flank)
        if (yield from self._refine_gen(ref_seq)) is not None:
            alt_seq = ref_seq[:flank] + \
                self.fetch(chrom, e - flank, e, revcomp=True)
            w = yield from self._refine_gen(alt_seq)
            if w is not None:
                reads = self.reads(chrom, s - flank, s + flank, flank)
                if len(reads) > num_reads_cff:
                    trace.count("validate.junction")
                    raw = yield self._score_async(
                        "within_10perc_m1b", ref_seq, alt_seq, reads, w)
                    self._accumulate(raw, reads, scores, state)
                    self._figure(scores, state, w, ref_seq, alt_seq,
                                 fig_name)
        return scores

    def validate_tandup_gen(self, num_reads_cff: int, sv_info: Sequence,
                            fig_name: str = ""):
        """pyx:1747-1784."""
        chrom, s, e = sv_info[0], int(sv_info[1]), int(sv_info[2])
        flank = flank_length_calculate([chrom, s, e])
        scores: List[float] = []
        state: Dict = {}
        if e - s < self.cfg.max_sv_test:
            ref_seq = self.fetch(chrom, s - flank, e + flank)
            if (yield from self._refine_gen(ref_seq)) is not None:
                body = ref_seq[flank:-flank]
                alt_seq = ref_seq[:flank] + body + body + ref_seq[-flank:]
                w = yield from self._refine_gen(alt_seq)
                if w is not None:
                    reads = self.reads(chrom, s - flank,
                                       s + 2 * (e - s) + flank, flank)
                    if len(reads) > num_reads_cff:
                        raw = yield self._score_async(
                            "redefine_diagonal", ref_seq, alt_seq,
                            reads, w)
                        self._accumulate(raw, reads, scores, state)
                        self._figure(scores, state, w, ref_seq, alt_seq,
                                     fig_name)
                        return scores
        # junction fallback (pyx:1769-1784)
        ref_seq = self.fetch(chrom, e - flank, e + flank)
        if (yield from self._refine_gen(ref_seq)) is not None:
            alt_seq = self.fetch(chrom, e - flank, e) + \
                self.fetch(chrom, s, s + flank)
            w = yield from self._refine_gen(alt_seq)
            if w is not None:
                reads = self.reads(chrom, e - flank, e + flank, flank)
                if len(reads) > num_reads_cff:
                    trace.count("validate.junction")
                    raw = yield self._score_async(
                        "within_10perc_m1b", ref_seq, alt_seq, reads, w)
                    self._accumulate(raw, reads, scores, state)
                    self._figure(scores, state, w, ref_seq, alt_seq,
                                 fig_name)
        return scores

    def validate_ins_gen(self, num_reads_cff: int, ins_pos: str,
                         ins_seq: str, polarity: str = "+",
                         fig_name: str = ""):
        """pyx:1856-1893; ins_pos is 'chrom_pos'."""
        chrom = "_".join(ins_pos.split("_")[:-1])
        pos = int(ins_pos.split("_")[-1])
        ins_seq_2 = ins_seq if polarity == "+" else \
            reverse_complement(ins_seq)
        flank = self.cfg.default_flank_length \
            if len(ins_seq) > self.cfg.default_flank_length else len(ins_seq)
        scores: List[float] = []
        state: Dict = {}
        reads = self.reads(chrom, pos - flank, pos + len(ins_seq) + flank,
                           flank)
        if len(reads) > num_reads_cff:
            if len(ins_seq) < self.cfg.ins_long_seq:
                ref_seq = self.fetch(chrom, pos - flank,
                                     pos + flank + len(ins_seq))
                w = yield from self._refine_gen(ref_seq + ins_seq)
            else:
                ref_seq = self.fetch(chrom, pos - flank, pos + flank)
                w = yield from self._refine_gen(ref_seq)
            if w is not None:
                alt_seq = self.fetch(chrom, pos - flank, pos) + ins_seq_2 + \
                    self.fetch(chrom, pos, pos + flank)
                evaluable = [r for r in reads if
                             (r[0].count("N") + r[0].count("n")) /
                             float(len(r[0])) < self.cfg.read_n_fraction_cff]
                raw = yield self._score_async(
                    "abs_dis_m1b", ref_seq, alt_seq, evaluable, w)
                self._accumulate(raw, evaluable, scores, state)
                if ins_seq_2.count("X") == len(ins_seq_2):
                    self._figure(scores, state, w, ref_seq,
                                 ref_seq[2:flank], fig_name)
                else:
                    self._figure(scores, state, w, ref_seq, alt_seq,
                                 fig_name)
        return scores

    def validate_disdup_gen(self, num_reads_cff: int, sv_info: Sequence,
                            fig_name: str = ""):
        """pyx:1786-1854; sv_info = [chr, dup_s, dup_e, ins_chr, ins_pos]."""
        chrom, dup_s, dup_e = sv_info[0], int(sv_info[1]), int(sv_info[2])
        ins_chrom, ins_pos = sv_info[3], int(sv_info[4])
        flank = flank_length_calculate([chrom, dup_s, dup_e])
        bp_info = sorted([dup_s, dup_e, ins_pos])
        scores: List[float] = []
        state: Dict = {}
        run_flag = 0
        if chrom == ins_chrom and bp_info[-1] - bp_info[0] < \
                self.cfg.max_sv_test:
            ref_seq = self.fetch(chrom, bp_info[0] - flank,
                                 bp_info[-1] + flank)
            if (yield from self._refine_gen(ref_seq)) is not None:
                reads = self.reads(chrom, bp_info[0] - flank,
                                   bp_info[-1] + (dup_e - dup_s) + flank,
                                   flank)
                if len(reads) > num_reads_cff:
                    run_flag = 1
                    if ins_pos > dup_e:
                        alt_structure = ["a", "b", "a"]
                    elif ins_pos < dup_s:
                        alt_structure = ["b", "a", "b"]
                    else:
                        # reference raises NameError here (pyx:1803-1804)
                        return scores
                    a_seq = self.fetch(chrom, bp_info[0], bp_info[1])
                    b_seq = self.fetch(chrom, bp_info[1], bp_info[2])
                    alt_seq = self.fetch(chrom, bp_info[0] - flank,
                                         bp_info[0])
                    for unit in alt_structure:
                        alt_seq += a_seq if unit == "a" else b_seq
                    alt_seq += self.fetch(chrom, bp_info[-1],
                                          bp_info[-1] + flank)
                    w = yield from self._refine_gen(alt_seq)
                    if w is not None:
                        raw = yield self._score_async(
                            "redefine_diagonal", ref_seq, alt_seq,
                            reads, w)
                        self._accumulate(raw, reads, scores, state)
                        self._figure(scores, state, w, ref_seq, alt_seq,
                                     fig_name)
        if run_flag == 0:
            if bp_info[-1] - bp_info[0] < self.cfg.max_sv_test:
                reads = self.reads(ins_chrom, ins_pos - flank,
                                   ins_pos + flank, flank)
                if len(reads) > num_reads_cff:
                    ref_seq = self.fetch(ins_chrom, ins_pos - flank,
                                         ins_pos + flank)
                    if (yield from self._refine_gen(ref_seq)) is not None:
                        alt_seq = ref_seq[:flank] + \
                            self.fetch(chrom, dup_s, dup_e) + \
                            ref_seq[-flank:]
                        w = yield from self._refine_gen(alt_seq)
                        if w is not None:
                            raw = yield self._score_async(
                                "abs_dis_m1b", ref_seq, alt_seq,
                                reads, w)
                            self._accumulate(raw, reads, scores, state)
                            self._figure(scores, state, w, ref_seq,
                                         alt_seq, fig_name)
            else:
                reads = self.reads(ins_chrom, ins_pos - flank,
                                   ins_pos + flank, flank)
                if len(reads) > num_reads_cff:
                    ref_seq = self.fetch(ins_chrom, ins_pos - flank,
                                         ins_pos + flank)
                    if (yield from self._refine_gen(ref_seq)) is not None:
                        alt_seq = ref_seq[:flank] + \
                            self.fetch(chrom, dup_s, dup_s + flank)
                        w = yield from self._refine_gen(alt_seq)
                        if w is not None:
                            raw = yield self._score_async(
                                "within_10perc_m1b", ref_seq, alt_seq,
                                reads, w)
                            self._accumulate(raw, reads, scores, state)
                            self._figure(scores, state, w, ref_seq,
                                         alt_seq, fig_name)
        return scores

    def validate_dup_inv_gen(self, num_reads_cff: int, sv_info: Sequence,
                             fig_name: str = ""):
        """pyx:1595-1669; sv_info = [chr, dup_s, dup_e, ins_chr, ins_pos]."""
        chrom, dup_s, dup_e = sv_info[0], int(sv_info[1]), int(sv_info[2])
        ins_chrom, ins_pos = sv_info[3], int(sv_info[4])
        flank = flank_length_calculate([chrom, dup_s, dup_e])
        scores: List[float] = []
        state: Dict = {}
        if chrom != ins_chrom:
            return scores
        bp_info = sorted([dup_s, dup_e, ins_pos])
        run_flag = 0
        if bp_info[-1] - bp_info[0] < self.cfg.max_sv_test:
            ref_seq = self.fetch(chrom, bp_info[0] - flank,
                                 bp_info[-1] + flank)
            if (yield from self._refine_gen(ref_seq)) is not None:
                run_flag = 1
                if ins_pos > dup_e:
                    alt_structure = ["a", "b", "a^"]
                elif ins_pos < dup_s:
                    alt_structure = ["b^", "a", "b"]
                else:
                    alt_structure = ["a", "a^"]
                reads = self.reads(chrom, bp_info[0] - flank,
                                   bp_info[-1] + (dup_e - dup_s) + flank,
                                   flank)
                if len(reads) > num_reads_cff:
                    a_seq = self.fetch(chrom, bp_info[0], bp_info[1])
                    b_seq = self.fetch(chrom, bp_info[1], bp_info[2])
                    alt_seq = self.fetch(chrom, bp_info[0] - flank,
                                         bp_info[0])
                    for unit in alt_structure:
                        base = a_seq if unit[0] == "a" else b_seq
                        alt_seq += reverse_complement(base) \
                            if unit.endswith("^") else base
                    alt_seq += self.fetch(chrom, bp_info[-1],
                                          bp_info[-1] + flank)
                    w = yield from self._refine_gen(alt_seq)
                    if w is not None:
                        raw = yield self._score_async(
                            "redefine_diagonal", ref_seq, alt_seq,
                            reads, w)
                        self._accumulate(raw, reads, scores, state,
                                         nan_guard=True)
                        self._figure(scores, state, w, ref_seq, alt_seq,
                                     fig_name)
        if run_flag == 0:
            ref_seq = self.fetch(ins_chrom, ins_pos - flank,
                                 ins_pos + flank)
            if (yield from self._refine_gen(ref_seq)) is not None:
                reads = self.reads(ins_chrom, ins_pos - flank,
                                   ins_pos + flank, flank)
                if len(reads) > num_reads_cff:
                    if bp_info[-1] - bp_info[0] < self.cfg.max_sv_test:
                        alt_seq = ref_seq[:flank] + reverse_complement(
                            self.fetch(chrom, dup_s, dup_e)) + \
                            ref_seq[-flank:]
                        scorer = "abs_dis_m1b"
                    else:
                        alt_seq = ref_seq[:flank] + reverse_complement(
                            self.fetch(chrom, dup_e - flank, dup_e))
                        scorer = "within_10perc_m1b"
                    w = yield from self._refine_gen(alt_seq)
                    if w is not None:
                        raw = yield self._score_async(
                            scorer, ref_seq, alt_seq, reads, w)
                        self._accumulate(raw, reads, scores, state,
                                         nan_guard=True)
                        self._figure(scores, state, w, ref_seq, alt_seq,
                                     fig_name)
        return scores

    def validate_del_inv_gen(self, num_reads_cff: int, sv_info: Sequence,
                             fig_name: str = ""):
        """pyx:1557-1593; sv_info = [[chr,s,e,'del'], [chr,s,e,'inv'],...]
        ordered by start."""
        sv_block = [sv_info[0][0], int(sv_info[0][1]), int(sv_info[-1][2])]
        flank = flank_length_calculate(sv_block)
        scores: List[float] = []
        state: Dict = {}
        if int(sv_info[1][1]) - int(sv_info[0][2]) < 100:
            if sv_block[2] - sv_block[1] < self.cfg.max_sv_test:
                ref_seq = self.fetch(sv_block[0], sv_block[1] - flank,
                                     sv_block[2] + flank)
                if (yield from self._refine_gen(ref_seq)) is not None:
                    alt_seq = ref_seq[:flank]
                    for block in sv_info:
                        if block[-1] == "del":
                            continue
                        if block[-1] == "inv":
                            alt_seq += reverse_complement(
                                self.fetch(block[0], block[1], block[2]))
                    alt_seq += ref_seq[-flank:]
                    w = yield from self._refine_gen(alt_seq)
                    if w is not None:
                        reads = self.reads(
                            sv_block[0], sv_block[1] - flank,
                            sv_block[1] + len(alt_seq) - flank, flank)
                        if len(reads) > num_reads_cff:
                            raw = yield self._score_async(
                                "abs_dis_m1b", ref_seq, alt_seq,
                                reads, w)
                            self._accumulate(raw, reads, scores, state)
                            self._figure(scores, state, w, ref_seq,
                                         alt_seq, fig_name)
                        elif len(sv_info) == 2 and \
                                [b[-1] for b in sv_info] == ["del", "inv"]:
                            scores = yield from \
                                self.validate_long_del_inv_gen(
                                    num_reads_cff, sv_info, fig_name)
            else:
                if len(sv_info) == 2 and \
                        [b[-1] for b in sv_info] == ["del", "inv"]:
                    scores = yield from self.validate_long_del_inv_gen(
                        num_reads_cff, sv_info, fig_name)
        else:
            # non-adjacent blocks: dispatch each separately (the
            # reference's stale-signature call would crash, pyx:1591-1592)
            for block in sv_info:
                if "del" in block:
                    scores += yield from self.validate_del_gen(
                        num_reads_cff, block[:-1], fig_name)
                elif "inv" in block:
                    scores += yield from self.validate_inv_gen(
                        num_reads_cff, block[:-1], fig_name)
        return scores

    def validate_long_del_inv_gen(self, num_reads_cff: int,
                                  sv_info: Sequence, fig_name: str = ""):
        """pyx:1671-1691 — breakpoint-junction mode for del+inv pairs."""
        flank = 500
        scores: List[float] = []
        state: Dict = {}
        d_chr, d_s = sv_info[0][0], int(sv_info[0][1])
        i_chr, i_s, i_e = sv_info[1][0], int(sv_info[1][1]), \
            int(sv_info[1][2])
        ref_seq = self.fetch(d_chr, d_s - flank, i_s + flank)
        if (yield from self._refine_gen(ref_seq)) is not None:
            alt_seq = ref_seq[:flank] + reverse_complement(
                self.fetch(i_chr, i_e - flank, i_e))
            w = yield from self._refine_gen(alt_seq)
            if w is not None:
                reads = self.reads(d_chr, d_s - flank, d_s + flank, flank)
                if len(reads) > num_reads_cff:
                    raw = yield self._score_async(
                        "within_10perc_m1b", ref_seq, alt_seq, reads, w)
                    self._accumulate(raw, reads, scores, state)
                    self._figure(scores, state, w, ref_seq, alt_seq,
                                 fig_name)
        return scores

    def validate_complex_gen(self, num_reads_cff: int, sv_info: Sequence,
                             fig_name: str = ""):
        """pyx:1490-1555 — generic letter-grammar events ('Other=')."""
        ref_sv = sv_info[0].split("_")
        alt_sv = _unique([h for h in sv_info[1].split("_")
                          if h not in ref_sv])
        chromos = self.fasta.references
        bp_info = block_subsplot([str(t) for t in sv_info[2:]], chromos)
        flank = max(flank_length_calculate(b) for b in bp_info)
        scores: List[float] = []
        run_flag = 0
        if len(bp_info) == 1:
            bps = bp_info[0]
            if bps[-1] - bps[1] < self.cfg.max_sv_test:
                ref_seq = self.fetch(bps[0], bps[1] - flank,
                                     bps[-1] + flank)
                if (yield from self._refine_gen(ref_seq)) is not None:
                    reads = self.reads(bps[0], bps[1] - flank,
                                       bps[-1] + flank, flank)
                    let_hash = bp_to_chr_hash(bps, chromos, flank)
                    if len(reads) > num_reads_cff:
                        run_flag = 1
                        let_seq = {
                            k: self.fetch(v[0], v[1], v[-1])
                            for k, v in let_hash.items()}
                        for alt_allele in alt_sv:
                            alt_seq = ref_seq[:flank]
                            for unit in letter_split(alt_allele):
                                if "^" not in unit:
                                    alt_seq += let_seq[unit]
                                else:
                                    alt_seq += reverse_complement(
                                        let_seq[unit[0]])
                            alt_seq += ref_seq[-flank:]
                            w = yield from self._refine_gen(alt_seq)
                            if w is None:
                                continue
                            has_dup = max(
                                [alt_allele.count(c) for c in alt_allele]
                                + [0]) > 1
                            scorer = "redefine_diagonal" if has_dup \
                                else "abs_dis_m1b"
                            state: Dict = {}
                            raw = yield self._score_async(
                                scorer, ref_seq, alt_seq, reads, w)
                            self._accumulate(raw, reads, scores, state)
                            # per-allele figure name (pyx:1526)
                            parts = fig_name.split(".")
                            allele_fig = ".".join(
                                parts[:-1] + [ref_sv[0] + ".vs."
                                              + alt_allele, parts[-1]]) \
                                if fig_name else fig_name
                            self._figure(scores, state, w, ref_seq,
                                         alt_seq, allele_fig)
            if run_flag == 0:
                for alt_allele in alt_sv:
                    juncs = block_around_check(alt_allele, ref_sv[0])
                    let_hash = bp_to_chr_hash(bp_info[0], chromos, flank)
                    for junc in juncs:
                        scores += yield from self._score_junction_gen(
                            num_reads_cff, junc, let_hash, flank)
        return scores

    def _score_junction_gen(self, num_reads_cff: int, junc: Sequence[str],
                            let_hash: Dict, flank: int):
        """One novel-junction check of the complex fallback
        (pyx:1531-1549)."""
        scores: List[float] = []
        j0, j1 = junc[0], junc[1]
        h0, h1 = let_hash[j0[0]], let_hash[j1[0]]
        if "^" not in j0:
            seq_a = self.fetch(h0[0], int(h0[2]) - flank,
                               int(h0[2]) + flank)
        else:
            seq_a = self.fetch(h0[0], int(h0[1]) - flank,
                               int(h0[1]) + flank, revcomp=True)
        if "^" not in j1:
            seq_b = self.fetch(h1[0], int(h1[1]) - flank,
                               int(h1[1]) + flank)
        else:
            seq_b = self.fetch(h1[0], int(h1[2]) - flank,
                               int(h1[2]) + flank, revcomp=True)
        if (yield from self._refine_gen(seq_a + seq_b)) is None:
            return scores
        alt_seq = seq_a[-flank:] + seq_b[:flank]
        w = yield from self._refine_gen(alt_seq)
        if w is None:
            return scores
        anchor = int(h0[2]) if "^" not in j0 else int(h0[1])
        reads = self.reads(h0[0], anchor - flank, anchor + flank, flank)
        if len(reads) > 0:
            raw = yield self._score_async(
                "within_10perc_m1b", seq_a, alt_seq, reads, w)
            state: Dict = {}
            self._accumulate(raw, reads, scores, state)
        return scores
