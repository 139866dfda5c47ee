"""Usage/readme printers + version string.

The counterpart of the reference's second compiled extension, ``prep``
(vapor_vali/prep.pyx:1-52): a tiny module of per-mode usage texts and
the tool version, importable programmatically (the reference CLI calls
``prep.print_read_me()`` etc. from its legacy help paths).  Here the
argparse surface already auto-generates help; these functions give the
same mode-by-mode summaries, under this package's program name and its
``vapor_version`` (the one ``--version`` prints).
"""
from __future__ import annotations

from . import vapor_version

PROG = "vapor-tpu-torch"

_COMMON = [
    ("--sv-input", "input file of SV calls"),
    ("--output-path", "folder where the recurrence plots will be kept"),
    ("--reference", "reference genome the long reads are aligned against"),
    ("--pacbio-input", "absolute path of the input long-read BAM"),
]


def _print_usage(mode: str, params) -> None:
    print(vapor_version)
    print("")
    print(f"Usage: {PROG} {mode} [Parameters]")
    print("Parameters:")
    for flag, desc in params:
        print(f"\t{flag}:\t{desc}")


def print_read_me() -> None:
    print(vapor_version)
    print("")
    print(f"Usage: {PROG} [Options] [Parameters]")
    print("Options: ")
    for mode in ("svelter", "vcf", "bed", "ins", "pdf", "scatter"):
        print(f"\t{mode}")
    print("Parameters:")
    for flag, desc in _COMMON:
        print(f"\t{flag}:\t{desc}")


def readme_bed() -> None:
    _print_usage("bed", [
        ("--sv-input",
         "input file in bed format with SV type labeled in the last "
         "column"),
        ("--output-file", "name of output file including vapor scores"),
    ] + _COMMON[1:])


def readme_vcf() -> None:
    _print_usage("vcf", [("--sv-input", "input file in vcf format")]
                 + _COMMON[1:])


def readme_melt() -> None:
    _print_usage("ins", [
        ("--sv-input", "prefix of input files in vcf and fa format"),
    ] + _COMMON[1:])


def readme_svelter() -> None:
    _print_usage("svelter", [
        ("--sv-input", "input file in svelter format"),
        ("--output-file", "name of output file including vapor scores"),
    ] + _COMMON[1:])


READMES = {
    "bed": readme_bed,
    "vcf": readme_vcf,
    "ins": readme_melt,
    "svelter": readme_svelter,
}
