"""A tiny copy of the benchmark's data files for CPU runs: every cell at
a few events a contig, short reads and a low depth, so that a whole run
(set-up, window, check) takes seconds on the CPU."""
import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from benchmarks import harness  # noqa: E402

# A bed-mode configuration for the CPU tests alone, beside the bed cell
# of BENCHMARK.json (na12878_1kgp.clr30x): the generator and the
# reference know every type of both input modes (DEL, INS, INV, tandem
# DUP, junction mode), so that a configuration of the benchmark is a
# data file, and this one puts an INV, a DUP and junction mode in a
# run of a few events.
BED = "bed_tiny.clr30x"
BED_CONFIG = {"name": "bed_tiny", "mode": "bed",
              "types": {"DEL": 0.34, "INV": 0.33, "DUP": 0.33},
              "sizes": [[600, 1500, 0.67], [10000, 11000, 0.33]],
              "hom_share": 0.3333, "layout_seed": 20170401,
              "control": "float32", "guarantees": [], "reduced": [],
              "assumed": []}
BED_ENTRY = {"name": "bed_tiny", "source": "x",
             "file": "benchmarks/configs/bed_tiny.json", "reduced": [],
             "why": "x"}
BED_CELL = {"name": BED, "config": "bed_tiny", "traffic": "clr30x",
            "chips": 1, "why": "bed"}
TINY_READS = {"median": 4000, "sigma": 0.3, "min": 2000, "max": 8000}


def make_tiny(dest: str, events: int = 3) -> str:
    """Copies BENCHMARK.json and the benchmark's data and readers into
    `dest`, cut to a tiny size, with the bed-mode cell added; returns the
    copy's BENCHMARK.json."""
    bench = os.path.join(dest, "benchmarks")
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(harness.BENCH, sub),
                        os.path.join(bench, sub))
    shutil.copy(os.path.join(harness.BENCH, "peaks.json"), bench)
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    spec["configs"].append(BED_ENTRY)
    spec["workloads"].append(BED_CELL)
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "hg002_tier1.clr30x" in m.get("workloads", ()):
            m["workloads"].append(BED)
    with open(os.path.join(dest, BED_ENTRY["file"]), "w") as fh:
        json.dump(BED_CONFIG, fh)
    for c in spec["configs"]:
        path = os.path.join(dest, c["file"])
        with open(path) as fh:
            cfg = json.load(fh)
        cfg.update(events_per_contig=events, check_events=2 * events,
                   spacing_mean_bp=6000)
        if cfg["mode"] == "vcf":     # bed: one junction-mode call a type
            cfg["sizes"] = [[60, 300, 0.6], [300, 1200, 0.4]]
        with open(path, "w") as fh:
            json.dump(cfg, fh)
    for name in os.listdir(os.path.join(bench, "traffic")):
        path = os.path.join(bench, "traffic", name)
        with open(path) as fh:
            tr = json.load(fh)
        tr.update(depth=12, read_length=TINY_READS, contigs=2)
        with open(path, "w") as fh:
            json.dump(tr, fh)
    spec_path = os.path.join(dest, "BENCHMARK.json")
    with open(spec_path, "w") as fh:
        json.dump(spec, fh)
    return spec_path


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """(load_cell for the tiny copy, its root); work under tmp_path."""
    spec = make_tiny(str(tmp_path / "root"))
    monkeypatch.setenv("TMPDIR", str(tmp_path / "tmp"))

    def load(name):
        return harness.load_cell(name, spec, os.path.join(
            os.path.dirname(spec), "benchmarks"))
    return load, os.path.dirname(spec)


def run_tiny(cell, seed=7, seconds=1.0, trace=False):
    return harness.run_cell(cell, seed, seconds, trace, device="cpu")
