"""`.vapor` TSV output (write_output_initiate/main, pyx:2079-2088).

Rows are appended per event (accidentally resumable at file granularity,
like the reference); NA rows carry NA for QS/GS/GT/GQ/Rec.
"""
from __future__ import annotations

from typing import Sequence

from ..stats.genotype import estimate_genotype

HEADER = ["#CHR", "POS", "END", "SVTYPE", "SVID",
          "VaPoR_QS", "VaPoR_GS", "VaPoR_GT", "VaPoR_GQ", "VaPoR_Rec"]


def initiate_output(out_name: str) -> None:
    with open(out_name, "w") as fo:
        fo.write("\t".join(HEADER) + "\n")


def append_result_row(out_name: str, out_list: Sequence) -> None:
    """Append one event row: (..., QS, GS, rec) -> +GT/GQ before rec."""
    with open(out_name, "a") as fo:
        if "NA" not in out_list:
            row = list(out_list[:-1]) + estimate_genotype(out_list) + \
                [out_list[-1]]
        else:
            row = list(out_list[:-1]) + ["NA", "NA", "NA"]
        fo.write("\t".join(str(i) for i in row) + "\n")
