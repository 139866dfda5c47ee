"""vapor_tpu_torch's --resume: a bed run cut back to its header and first
row (as tests/test_orchestrate_cli.py::test_resume does for vapor_tpu),
or to a row cut off mid-write, and a run of the scale fixture killed
with SIGKILL in a subprocess, each restarted with --resume, give the
bytes of one uninterrupted run; in the killed case without scoring the
finished events again."""
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

from vapor_tpu_torch.cli import main
from vapor_tpu_torch.sim.scale import build_scale_case
from vapor_tpu_torch.sim.synth import build_test_case

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)      # the suite runs several processes at once


def _bed_args(bed, fa, bam, out, figs):
    return ["bed", "--sv-input", bed, "--reference", fa, "--pacbio-input",
            bam, "--output-path", figs, "--output-file", out,
            "--backend", "torch", "--device", "cpu", "--no-figures"]


@pytest.fixture(scope="module")
def small_run(tmp_path_factory):
    """(CLI arguments, the uninterrupted output) of a two-event bed run of
    test_orchestrate_cli.py's case, through the port's default
    backend."""
    d = tmp_path_factory.mktemp("resume")
    case = build_test_case(str(d), genome_len=16000, sv=("DEL", 7000, 7300),
                           read_len=2200, n_donor=6, n_ref=6, seed=21)
    bed = d / "svs.bed"
    bed.write_text("chrS\t7000\t7300\tSV1\tDEL\n"
                   "chrS\t9000\t9200\tSV2\tINV\n")
    out = str(d / "o.vapor")
    args = _bed_args(str(bed), case["fasta"], case["bam"], out,
                     str(d / "figs"))
    assert main(args) == 0
    with open(out) as fh:
        full = fh.read()
    assert len(full.splitlines()) == 3
    return args, out, full


@pytest.mark.parametrize("cut", ["first_row", "mid_row", "header"])
def test_resume_after_truncation(small_run, cut):
    """Cut back to the header and the first row, to those and half of the
    second row (no newline: a write cut off), or to half the header;
    --resume restores the full output."""
    args, out, full = small_run
    lines = full.splitlines(keepends=True)
    kept = {"first_row": "".join(lines[:2]),
            "mid_row": "".join(lines[:2]) + lines[2][:len(lines[2]) // 2],
            "header": lines[0][:5]}[cut]
    with open(out, "w") as fh:
        fh.write(kept)
    assert main(args + ["--resume"]) == 0
    with open(out) as fh:
        assert fh.read() == full


def test_resume_after_kill(tmp_path):
    """The scale fixture (2 contigs, 16 events) in a subprocess with
    --resume, killed (SIGKILL) once its first rows are written, then
    rerun with --resume: the bytes of an uninterrupted in-process run,
    and the rows written before the kill are kept, not written again."""
    case = build_scale_case(str(tmp_path), n_contigs=2, contig_len=60000,
                            events_per=18, reads_per=6)
    n = case["n_events"]
    want = str(tmp_path / "want.vapor")
    assert main(_bed_args(case["bed"], case["fasta"], case["bam"], want,
                          str(tmp_path / "figs_want"))) == 0
    out = str(tmp_path / "killed.vapor")
    args = _bed_args(case["bed"], case["fasta"], case["bam"], out,
                     str(tmp_path / "figs")) + ["--resume"]

    def rows():
        if not os.path.exists(out):
            return []
        with open(out) as fh:
            return [x for x in fh if not x.startswith("#")]

    proc = subprocess.Popen(
        [sys.executable, "-m", "vapor_tpu_torch", *args, "--pipeline", "1"],
        cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 300
        while proc.poll() is None and len(rows()) < 2 and \
                time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
    at_kill = rows()
    assert proc.returncode == -signal.SIGKILL
    assert 2 <= len(at_kill) < n
    whole = [x for x in at_kill if x.endswith("\n")]
    assert main(args) == 0
    with open(out) as fh, open(want) as fw:
        got_text, want_text = fh.read(), fw.read()
    assert got_text == want_text
    assert got_text.count("\n") == n + 1
    assert got_text.startswith(
        want_text.splitlines(keepends=True)[0] + "".join(whole))
