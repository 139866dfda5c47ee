"""Centralized algorithm constants.

The reference scatters ~15 numeric constants across module globals and
legacy parameter readers (Simple_function.pyx:18-26, vapor:208-253).
Exact output parity depends on these values, so they live in one frozen
dataclass here.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class VaporConfig:
    # Haplotype construction (pyx:21-26, 794-802)
    default_flank_length: int = 500     # pyx:22
    default_read_length: int = 4000     # pyx:24 (average PacBio read length)
    max_sv_test: int = 10000            # pyx:26 — larger SVs use junction mode

    # Read extraction (pyx:339-354, 1091-1102)
    ideal_read_list_length: int = 20    # pyx:1091 — subsample cap per event
    num_reads_cff: int = 3              # vapor:305,325,378 — min evaluable reads

    # Window-size adaptation (pyx:2030-2046)
    window_size_start: int = 10
    window_size_step: int = 10
    window_size_max: int = 40           # loop breaks once window_size > 30
    region_qc_cff: float = 0.4          # pyx:2030 — diagonal-fraction cutoff
    repeat_mass_cff: float = 0.3        # pyx:2039 — off-diagonal cluster mass / len
    max_n_count: int = 100              # pyx:2033 — too many Ns -> Error

    # Dot-cloud cleaning (pyx:551-580)
    dis_cff: int = 10                   # gap threshold for 1-D offset clustering
    dis_cluster_keep: int = 50          # dis_cluster: keep clusters with > 50 dots
    dis_cluster_2_keep: int = 10        # dis_cluster_2: keep clusters with > 10 dots

    # Scorer gates (pyx:182-307)
    coverage_cff: float = 0.1           # dots/len gate
    span_cff_m1b: float = 0.6           # abs_dis_m1b span gate
    span_cff_strict: float = 0.7        # m1/directed/redefine span gate
    within_10perc_cff: float = 0.16     # relative-deviation cutoff (pyx:733)
    dir_deviation_cff: float = 0.1      # eu_dis_dir_calcu gate (pyx:720)
    reg_deviation_cff: float = 0.15     # eu_dis_reg_calcu gate (pyx:726)

    # Event-level filters (vapor:393-412)
    min_sv_span: int = 50               # DEL/INV below this emit NA rows

    # Genotyper (pyx:2054-2077)
    genotype_err: float = 0.05
    gs_het_override: float = 0.15       # 0/0 -> 0/1 when GS > 0.15 (pyx:2068)

    # INS handling (pyx:1856-1893)
    ins_long_seq: int = 5000            # pyx:1867 — window QC uses ref only beyond this
    read_n_fraction_cff: float = 0.1    # pyx:1878 — skip reads with >10% N


DEFAULT_CONFIG = VaporConfig()
