"""SV input parsers: BED, VCF, MELT, SVelter.

Port of the reference CLI parsers: ``bed_info_readin`` (vapor:22-50),
``vcf_list_readin`` (vapor:127-202), ``del_inv_interprete`` /
``dup_inv_interprete`` (vapor:99-125), ``svelter_readin`` (vapor:255-268)
and the INFO-field extractors (pyx:365-371, 1424-1456).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple


# --- VCF INFO extractors (pyx) ---------------------------------------------

def svtype_extract(pin: List[str]) -> str:
    svtype = ""
    for field in pin[7].split(";"):
        if "SVTYPE" in field:
            svtype = field.split("=")[1]
    if svtype == "":
        svtype = pin[4].replace("<", "").replace(">", "")
    return svtype


def chr_start_end_extract(pin: List[str]) -> List:
    out = [pin[0], int(pin[1])]
    for field in pin[7].split(";"):
        if field[:4] == "END=" and field.split("=")[0] == "END":
            out.append(int(field.split("=")[1]))
    return out


def sv_len_extract(pin: List[str]):
    out = ""
    for field in pin[7].split(";"):
        if "SVLEN" in field:
            out = field.split("=")[1]
    return out if out != "" else 0


def sv_seq_extract(pin: List[str]) -> str:
    for field in pin[7].split(";"):
        if field[:4] == "SEQ=":
            return field.split("=")[1]
    return ""


def sv_insert_point_extract(pin: List[str]) -> List:
    out = [0, 0]
    for field in pin[7].split(";"):
        if "insert_point=" in field:
            out = field.split("=")[1].split(":")
    return out


def ins_length_extract(pin: List[str]) -> int:
    out = 0
    for field in pin[7].split(";"):
        if "SVLEN=" in field:
            out = int(field.split("=")[1])
    return out


def genotype_extract(pin: List[str]) -> List[int]:
    """Per-sample GT allele sums (legacy filter, pyx:815-831)."""
    out = [0, 0]
    rec_pos = -1
    if "GT" in pin[8]:
        for field in pin[8].split(":"):
            rec_pos += 1
            if field == "GT":
                break
    genos = [s.split(":")[rec_pos] for s in pin[9:]]
    for g in genos:
        if "/" in g:
            out.append(1 if g == "./." else
                       sum(int(a) for a in g.split("/")))
        elif "|" in g:
            out.append(1 if g == ".|." else
                       sum(int(a) for a in g.split("|")))
        elif g == ".":
            out.append(1)
    return out


def geno_cn_extract(pin: List[str]) -> List[int]:
    """Per-sample CN-based genotype flags (legacy, pyx:804-813)."""
    rec_pos = -1
    if "CN" in pin[8]:
        for field in pin[8].split(":"):
            rec_pos += 1
            if field == "CN":
                break
    genos = [s.split(":")[rec_pos] for s in pin[9:]]
    return [0 if g == "2" else 1 for g in genos]


def polarity_extract(pin: List[str]) -> str:
    out = "+"
    for field in pin[7].split(";"):
        if "MEIINFO=" in field:
            out = field.split(",")[-1]
    return out


# --- BED (vapor:22-50) ------------------------------------------------------

def bed_info_readin(bed_input: str) -> List[List]:
    """5-col BED: chrom start end SVID type; INS may carry INS_<len> /
    INS_<seq> in col 5 or an explicit sequence in col 6."""
    out: List[List] = []
    with open(bed_input) as fin:
        for line in fin:
            pin = line.strip().split()
            if not pin:
                continue
            t = pin[4]
            if "DUP" in t or "duplication" in t:
                out.append([pin[0], int(pin[1]), int(pin[2]), pin[3],
                            "a/a", "a/aa"])
            elif "DEL" in t or "deletion" in t:
                out.append([pin[0], int(pin[1]), int(pin[2]), pin[3],
                            "a/a", "/a"])
            elif "INV" in t or "inversion" in t:
                out.append([pin[0], int(pin[1]), int(pin[2]), pin[3],
                            "a/a", "a/a^"])
            elif any(k in t for k in
                     ("INS", "ALU", "HERVK", "LINE1", "SVA", "insertion")):
                if len(pin) > 5:
                    out.append([pin[0], int(pin[1]), int(pin[2]), pin[3],
                                pin[5], "INS"])
                elif "_" in t:
                    token = t.split("_")[1]
                    value = int(token) if token.isdigit() else token
                    out.append([pin[0], int(pin[1]), int(pin[2]), pin[3],
                                value, "INS"])
    return out


def bed4_info_readin(bed_input: str) -> List[List]:
    """4-col BED (type in col 4) as accepted by vapor_pdf:111-130.

    INS rows may carry ``INS_<len>`` / ``INS_<seq>`` in the type token;
    the returned rows use the 6-field layout of bed_info_readin with a
    synthesized SVID (``<chrom>_<start>``)."""
    out: List[List] = []
    with open(bed_input) as fin:
        for line in fin:
            pin = line.strip().split()
            if not pin or len(pin) < 4:
                continue
            chrom, start, end, t = pin[0], int(pin[1]), int(pin[2]), pin[3]
            svid = f"{chrom}_{start}"
            if "DUP" in t or "duplication" in t:
                out.append([chrom, start, end, svid, "a/a", "a/aa"])
            elif "DEL" in t or "deletion" in t:
                out.append([chrom, start, end, svid, "a/a", "/a"])
            elif "INV" in t or "inversion" in t:
                out.append([chrom, start, end, svid, "a/a", "a/a^"])
            elif any(k in t for k in
                     ("INS", "ALU", "HERVK", "LINE1", "SVA", "insertion")):
                if "_" in t:
                    token = t.split("_")[1]
                    value = int(token) if token.isdigit() else token
                    out.append([chrom, start, end, svid, value, "INS"])
    return out


# --- complex INFO interpreters (vapor:84-125) -------------------------------

def _block_reorganize(block_hash: Dict) -> object:
    if len(block_hash) != 1:
        return "error"
    for blocks in block_hash.values():
        starts = [b[1] for b in blocks]
        order = [starts.index(s) for s in sorted(starts)]
        seen: List[List] = []
        for idx in order:
            if blocks[idx] not in seen:
                seen.append(blocks[idx])
        return seen


def del_inv_interprete(pin: List[str]) -> object:
    out: Dict[str, List] = {}
    for field in pin[7].split(";"):
        if "del=" in field or "DEL=" in field:
            loc = field.split("=")[1]
            block = [loc.split(":")[0]] + \
                [int(v) for v in loc.split(":")[1].split("-")]
            out.setdefault(block[0], []).append(block + ["del"])
        elif "inv=" in field or "INV=" in field:
            loc = field.split("=")[1]
            block = [loc.split(":")[0]] + \
                [int(v) for v in loc.split(":")[1].split("-")]
            out.setdefault(block[0], []).append(block + ["inv"])
    return _block_reorganize(out)


def dup_inv_interprete(pin: List[str]) -> object:
    dup_seg: List = [pin[0], int(pin[1])]
    insert_pos: List = []
    for field in pin[7].split(";"):
        if "END=" in field:
            dup_seg.append(int(field.split("=")[1]))
        if "insert_point" in field or "INSERT_POINT" in field:
            insert_pos = field.split("=")[1].split(":")
    if len(insert_pos) > 1:
        return dup_seg + [insert_pos[0], int(insert_pos[1])]
    return "error"


# --- VCF worklist (vapor:127-202) -------------------------------------------

def vcf_list_readin(vcf_input: str) -> Tuple[Dict, Dict[int, str]]:
    """Group VCF records by SVTYPE; returns ({TYPE: [events]},
    {record_index: dedup_key})."""
    out: Dict[str, List] = {}
    rec_hash: Dict[int, str] = {}
    rec = -1
    with open(vcf_input) as fin:
        for line in fin:
            rec += 1
            pin = line.strip().split()
            if not pin or pin[0][0] == "#":
                continue
            pin[7] = pin[7].replace("MERGE_TYPE=", "SVTYPE=")
            sv_type = svtype_extract(pin)
            sv_pos = chr_start_end_extract(pin)
            if sv_type in ("del", "DEL", "deletion"):
                if sv_pos not in out.setdefault("DEL", []):
                    out["DEL"].append(sv_pos)
                    rec_hash[rec] = ":".join(
                        [str(i) for i in sv_pos] + ["DEL"])
            elif sv_type in ("inv", "INV", "inversion"):
                if sv_pos not in out.setdefault("INV", []):
                    out["INV"].append(sv_pos)
                    rec_hash[rec] = ":".join(
                        [str(i) for i in sv_pos] + ["INV"])
            elif sv_type in ("ins", "INS", "insertion", "LINE1", "SVA",
                             "ALU", "HERVK"):
                sv_len = int(sv_len_extract(pin))
                ins_seq = sv_seq_extract(pin)
                if sv_len > 0:
                    if sv_pos not in out.setdefault("INS", []):
                        out["INS"].append(sv_pos[:2] + [sv_len, ins_seq])
                        rec_hash[rec] = ":".join(
                            [str(i) for i in sv_pos[:2] + [sv_len]]
                            + ["INS"])
            elif sv_type in ("disdup", "DISDUP", "dis-dup"):
                insert_point = sv_insert_point_extract(pin)
                if sv_pos not in out.setdefault("DISDUP", []):
                    out["DISDUP"].append(sv_pos + insert_point)
                    rec_hash[rec] = ":".join(
                        [str(i) for i in sv_pos + insert_point]
                        + ["DISDUP"])
            elif sv_type in ("DEL_INV", "del_inv"):
                info = del_inv_interprete(pin)
                if info != "error":
                    if info not in out.setdefault("DEL_INV", []):
                        out["DEL_INV"].append(info)
                        rec_hash[rec] = ":".join(
                            ["_".join(str(i) for i in blk)
                             for blk in info] + ["DEL_INV"])
            elif sv_type in ("DUP_INV", "dup_inv"):
                info = dup_inv_interprete(pin)
                if info != "error":
                    if info not in out.setdefault("DUP_INV", []):
                        out["DUP_INV"].append(info)
                        rec_hash[rec] = ":".join(
                            [str(i) for i in info] + ["DUP_INV"])
            elif sv_type in ("tandup", "TANDUP", "DUP"):
                if sv_pos not in out.setdefault("TANDUP", []):
                    out["TANDUP"].append(sv_pos)
                    rec_hash[rec] = ":".join(
                        [str(i) for i in sv_pos] + ["TANDUP"])
            elif sv_type in ("CNV", "CSV", "CPX"):
                continue
            else:
                if "Other=" in pin[7]:
                    info_fields = [f for f in pin[7].split(";")
                                   if f[:6] == "Other="]
                elif "OTHER=" in pin[7]:
                    info_fields = [f for f in pin[7].split(";")
                                   if f[:6] == "OTHER="]
                else:
                    continue
                parts = info_fields[0].split("=")[1].split("_")
                event = ["_".join(p.split("/")) for p in parts[:2]] + \
                    parts[2].split(":")
                if event not in out.setdefault("Other", []):
                    out["Other"].append(event)
                    rec_hash[rec] = ":".join(
                        [str(i) for i in event] + ["CANNOT_CLASSIFY"])
    return out, rec_hash


# --- SVelter (vapor:255-268) ------------------------------------------------

def svelter_readin(file_in: str) -> Dict[str, Dict[str, List[List[str]]]]:
    out: Dict[str, Dict[str, List[List[str]]]] = {}
    with open(file_in) as fin:
        fin.readline()
        for line in fin:
            pin = line.strip().split()
            if not pin:
                continue
            ref_struct = "_".join(pin[4].split("/"))
            alt_struct = "_".join(pin[5].split("/"))
            bps = pin[3].split(":")
            out.setdefault(ref_struct, {}).setdefault(alt_struct, [])
            if bps not in out[ref_struct][alt_struct]:
                out[ref_struct][alt_struct].append(bps)
    return out


# --- MELT (vapor:52-82) -----------------------------------------------------

def melt_records(melt_prefix: str, fasta_fetch) -> List[Tuple]:
    """Yield (key_event, ins_seq, polarity) per MELT VCF record.

    ``fasta_fetch(name)`` must return the whole-entry sequence of
    ``<prefix>.fa`` for a ``chrom_pos`` key (empty if absent).
    """
    out = []
    with open(melt_prefix + ".vcf") as fin:
        for line in fin:
            pin = line.strip().split()
            if not pin or pin[0][0] == "#":
                continue
            key_event = "_".join(pin[:2])
            ins_seq = fasta_fetch(key_event)
            if ins_seq == "":
                ins_seq = "X" * ins_length_extract(pin)
            if ins_seq != "" and "INS" in pin[3]:
                polarity = polarity_extract(pin)
                out.append((key_event, ins_seq.replace("N", "X"), polarity))
    return out
