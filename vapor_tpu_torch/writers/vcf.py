"""Annotated-VCF rewriting of the `.vapor` report.

Port of the second (live) ``vcf_vapor_modify`` definition
(pyx:1972-2028) with its quirks preserved:

* the `.vapor` file itself is overwritten with the annotated VCF;
* meta lines are whitespace-normalized (split + single-space rejoin);
* four ``##INFO`` headers are inserted right after the last existing
  ``##INFO`` run, one of them missing its closing ``>`` (pyx:2020);
* data rows gain ``;VaPor_GS=..;VaPor_GT=..;VaPor_GQ=..;VaPor_REC=..``
  (lowercase ``VaPor_`` in the data vs ``VaPoR_`` in the headers);
* only VCF records whose key matched a `.vapor` row are emitted.
"""
from __future__ import annotations

from typing import Dict, List

_EXTRA_INFO = [
    '##INFO=<ID=VaPoR_GS,Number=1,Type=Float,Description="VaPoR Score, '
    'representing the percentage of transverse long reads that support '
    'the prediction">',
    '##INFO=<ID=VaPoR_GT,Number=1,Type=String,Description="Genotype with '
    'the highest likelihood as estimated by VaPoR">',
    '##INFO=<ID=VaPoR_GQ,Number=1,Type=Float,Description="Genotype '
    'quality score - likelihood of the second most likely genotype on a '
    '-log10 normalized scale"',
    '##INFO=<ID=VaPoR_REC,Number=.,Type=Float,Description="Similarity '
    'scores assigned to each of the reads traversings the predicted SV">',
]


def invert_record_keys(rec_hash: Dict[int, str]) -> Dict[str, List[int]]:
    """vcf_rec_hash_modify (pyx:1935-1940): key -> [vcf row indices]."""
    out: Dict[str, List[int]] = {}
    for row_idx, key in rec_hash.items():
        out.setdefault(key, []).append(row_idx)
    return out


def annotate_vcf(vcf_input: str, key_to_rows: Dict[str, List[int]]) -> None:
    vapor_input = vcf_input + ".vapor"
    records: Dict[int, List[str]] = {}
    meta_info: List[List[str]] = []
    header: List[str] = []
    # record keys are LINE indices, matching vcf_list_readin (vapor:132);
    # the reference's live vcf_vapor_modify counts data rows instead
    # (pyx:1985) and mis-annotates/crashes on any VCF with headers —
    # a reference bug fixed here.
    rec = -1
    with open(vcf_input) as fin:
        for line in fin:
            rec += 1
            pin = line.strip().split()
            if not pin:
                continue
            if not pin[0][0] == "#":
                records[rec] = pin
            elif not pin[0] == "#CHROM":
                meta_info.append(pin)
            else:
                header = pin

    keep: List[int] = []
    with open(vapor_input) as fin:
        for line in fin:
            pin = line.strip().split()
            if not pin or pin[0] not in key_to_rows:
                continue
            for row_idx in key_to_rows[pin[0]]:
                gs = round(float(pin[2]), 2) if pin[2] != "NA" else pin[2]
                gt = pin[3]
                gq = round(float(pin[4]), 2) if pin[4] != "NA" else pin[4]
                rec_scores = pin[5]
                records[row_idx][7] += (
                    f";VaPor_GS={gs};VaPor_GT={gt}"
                    f";VaPor_GQ={gq};VaPor_REC={rec_scores}")
                keep.append(row_idx)

    with open(vapor_input, "w") as fo:
        prev_kind = ""
        for pin in meta_info:
            joined = " ".join(pin)
            kind = joined.split("=")[0]
            if prev_kind == "##INFO" and kind != "##INFO":
                for extra in _EXTRA_INFO:
                    fo.write(extra + "\n")
            fo.write(joined + "\n")
            prev_kind = kind
        fo.write("\t".join(header) + "\n")
        for row_idx in sorted(records):
            if row_idx in keep:
                fo.write("\t".join(str(i) for i in records[row_idx]) + "\n")
