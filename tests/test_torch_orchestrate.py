"""The port's scatter/merge orchestration (vapor_tpu_torch/orchestrate.py,
io/tabix.py) against vapor_tpu's, and `python -m vapor_tpu_torch
scatter --device cpu` (with --trace) against the port's single run and
vapor_tpu's output on the same multi-contig case."""
import os
import random
import subprocess
import sys

import pytest

from vapor_tpu import orchestrate as jorch
from vapor_tpu.cli import main as jax_main
from vapor_tpu.io import tabix as jtabix
from vapor_tpu.sim.scale import build_scale_case
from vapor_tpu_torch import orchestrate as torch_orch
from vapor_tpu_torch.cli import main
from vapor_tpu_torch.io import tabix as ttabix

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADER = ("#CHR\tPOS\tEND\tSVTYPE\tSVID\tVaPoR_QS\tVaPoR_GS\t"
          "VaPoR_GT\tVaPoR_GQ\tVaPoR_Rec\n")


def _read(path, mode="r"):
    with open(path, mode) as fh:
        return fh.read()


def test_split_and_merge_match_vapor_tpu(tmp_path):
    bed = tmp_path / "w.bed"
    bed.write_text("chr2\t10\t20\tA\tDEL\nchr10\t5\t9\tB\tDEL\n"
                   "chr2\t30\t40\tC\tINV\n")
    vcf = tmp_path / "w.vcf"
    vcf.write_text("##fileformat=VCFv4.2\n#CHROM\tPOS\n"
                   "chr2\t10\tA\nchr10\t5\tB\nchr2\t30\tC\n")
    for src in (bed, vcf):
        got = torch_orch.split_by_contig(str(src), str(tmp_path / "t"))
        want = jorch.split_by_contig(str(src), str(tmp_path / "j"))
        assert set(got) == set(want) == {"chr2", "chr10"}
        for contig in got:
            assert _read(got[contig]) == _read(want[contig])
    assert len(_read(got["chr2"]).splitlines()) == 4     # header + 2
    a = tmp_path / "a.vapor"
    b = tmp_path / "b.vapor"
    a.write_text("#H\nchr10\t5\t9\tDEL\tB\t0\t0\t0/0\t1\t0\n")
    b.write_text("#H\nchr2\t30\t40\tINV\tC\t0\t0\t0/0\t1\t0\n"
                 "chr2\t10\t20\tDEL\tA\t0\t0\t0/0\t1\t0\n")
    outs = []
    for merge, tag in ((torch_orch.merge_outputs, "t"),
                       (jorch.merge_outputs, "j")):
        outs.append(str(tmp_path / f"merged_{tag}.vapor"))
        merge([str(a), str(b)], outs[-1])
    assert _read(outs[0]) == _read(outs[1])
    lines = _read(outs[0]).splitlines()
    assert [x.split("\t")[0] for x in lines[1:]] == ["chr2", "chr2", "chr10"]
    assert [x.split("\t")[1] for x in lines[1:]] == ["10", "30", "5"]
    assert torch_orch._version_key("chr10") == jorch._version_key("chr10")


def _index_case(tmp_path):
    """test_tabix.py's first case: 3 contigs x 50 rows, one shard file
    each."""
    rng = random.Random(3)
    truth, shards, i = [], [], 0
    for chrom in ("chr1", "chr2", "chr10"):
        pos, rows = 1000, []
        for _ in range(50):
            pos += rng.randint(500, 3000)
            end = pos + rng.randint(50, 400)
            rows.append(f"{chrom}\t{pos}\t{end}\tDEL\tsv{i}\t0.9\t1.0\t0/1"
                        f"\t3.2\t0.9\n")
            truth.append((chrom, pos, end, f"sv{i}"))
            i += 1
        p = tmp_path / f"{chrom}.vapor"
        p.write_text(HEADER + "".join(rows))
        shards.append(str(p))
    return shards, truth


@pytest.mark.parametrize("index", [True, False])
def test_merge_compressed_matches_vapor_tpu(tmp_path, index):
    shards, truth = _index_case(tmp_path)
    got = str(tmp_path / "t.vapor.gz")
    want = str(tmp_path / "j.vapor.gz")
    torch_orch.merge_outputs(shards, got, compress=True, index=index)
    jorch.merge_outputs(shards, want, compress=True, index=index)
    assert _read(got, "rb") == _read(want, "rb")
    assert os.path.exists(got + ".tbi") == index
    if not index:
        return
    assert _read(got + ".tbi", "rb") == _read(want + ".tbi", "rb")
    for chrom, pos, end, svid in truth:
        hits = ttabix.tabix_query(got, chrom, pos, end)
        assert hits == jtabix.tabix_query(want, chrom, pos, end)
        assert any(h[4] == svid for h in hits), (chrom, pos, svid)
    lo, hi = 20000, 60000
    expect = sorted(s for c, p, e, s in truth
                    if c == "chr2" and p < hi and e > lo)
    assert sorted(h[4] for h in ttabix.tabix_query(got, "chr2", lo, hi)) \
        == expect
    assert ttabix.tabix_query(got, "chr2", 10, 20) == []
    assert ttabix.tabix_query(got, "chrZ", 0, 10 ** 9) == []


def test_multiblock_bgzf_matches_vapor_tpu(tmp_path):
    """test_tabix.py's second case: rows over several BGZF blocks."""
    rows, truth, pos = [], [], 100
    for i in range(1200):
        pos += 97
        rows.append(f"chrB\t{pos}\t{pos + 50}\tDEL\tx{i}\t{'P' * 120}\n")
        truth.append((pos, f"x{i}"))
    got, want = str(tmp_path / "t.gz"), str(tmp_path / "j.gz")
    ttabix.write_bgzf_indexed(got, HEADER + "".join(rows))
    jtabix.write_bgzf_indexed(want, HEADER + "".join(rows))
    assert _read(got, "rb") == _read(want, "rb")
    assert _read(got + ".tbi", "rb") == _read(want + ".tbi", "rb")
    for pos, svid in (truth[0], truth[600], truth[-1]):
        hits = ttabix.tabix_query(got, "chrB", pos, pos + 1)
        assert any(h[4] == svid for h in hits), (pos, svid)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """Three contigs, three events each (DEL, INV, DUP), and the port's
    single-process bed output on them."""
    d = str(tmp_path_factory.mktemp("scatter"))
    case = build_scale_case(d, n_contigs=3, contig_len=30000, events_per=2,
                            reads_per=6, n_false_per=0, seed=9)
    case["single"] = os.path.join(d, "single.vapor")
    assert main(["bed", "--sv-input", case["bed"], "--reference",
                 case["fasta"], "--pacbio-input", case["bam"],
                 "--output-path", os.path.join(d, "figs"),
                 "--output-file", case["single"], "--device", "cpu",
                 "--no-figures"]) == 0
    case["dir"] = d
    return case


def test_single_run_matches_vapor_tpu(case):
    out = os.path.join(case["dir"], "jax.vapor")
    assert jax_main(["bed", "--sv-input", case["bed"], "--reference",
                     case["fasta"], "--pacbio-input", case["bam"],
                     "--output-path", os.path.join(case["dir"], "jfigs"),
                     "--output-file", out, "--backend", "numpy",
                     "--no-figures"]) == 0
    assert _read(out, "rb") == _read(case["single"], "rb")
    assert _read(out).count("\n") == 10     # header + 9 events


def test_scatter_cli_matches_single_run_and_traces(case):
    """`python -m vapor_tpu_torch scatter --device cpu --jobs 2 --trace`:
    one shard process per contig, each on the CPU (the device is
    forwarded), merged into the single run's bytes; every shard prints
    its trace report."""
    out = os.path.join(case["dir"], "scatter.vapor")
    proc = subprocess.run(
        [sys.executable, "-m", "vapor_tpu_torch", "scatter", "--sv-input",
         case["bed"], "--reference", case["fasta"], "--pacbio-input",
         case["bam"], "--output-path", os.path.join(case["dir"], "work"),
         "--output-file", out, "--device", "cpu", "--no-figures",
         "--jobs", "2", "--trace"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert _read(out, "rb") == _read(case["single"], "rb")
    assert proc.stderr.count("--- vapor-tpu-torch trace ---") == 3
    assert proc.stderr.count("kernel hist launches=") == 3
    shards = sorted(f for f in os.listdir(os.path.join(case["dir"], "work",
                                                       "shards"))
                    if f.endswith(".out.vapor"))
    assert shards == ["chr1.out.vapor", "chr2.out.vapor", "chr3.out.vapor"]


def test_scatter_shards_take_one_card_each(tmp_path, monkeypatch):
    """4 shards on 2 (patched) cards: shard n, in launch order, runs on
    card n % 2 and is marked as one of several, so it splits no rows
    over the other card.  The commands are built, not run."""
    import torch
    from vapor_tpu_torch.parallel import mesh, multihost
    bed = tmp_path / "calls.bed"
    bed.write_text("".join(f"chr{c}\t1000\t1400\tSV{c}\tDEL\n"
                           for c in (2, 10, 1, 3)))
    shards = torch_orch.split_by_contig(str(bed), str(tmp_path / "work"))
    jobs = torch_orch.shard_jobs("bed", shards, "ref.fa", "reads.bam",
                                 str(tmp_path / "work"), device="cuda")
    assert [cmd[cmd.index("--sv-input") + 1] for cmd, _, _ in jobs] == [
        shards[c] for c in ("chr1", "chr2", "chr3", "chr10")]
    assert all(cmd[cmd.index("--device") + 1] == "cuda"
               for cmd, _, _ in jobs)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cards = []
    for _, env, _ in jobs:
        for name in ("WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
            monkeypatch.delenv(name, raising=False)
        for name in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
            monkeypatch.setenv(name, env[name])
        assert multihost.one_of_several()
        card = torch.device(multihost.rank_device("cuda"))
        assert mesh.mesh_devices(card) == [card]
        cards.append(card.index)
    assert cards == [0, 1, 0, 1]


def test_scatter_shard_without_a_card_exits_nonzero(case, monkeypatch):
    """A shard's environment with --device cuda and no card: the CLI
    exits 2 and falls back to nothing."""
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert main(["bed", "--sv-input", case["bed"], "--reference",
                 case["fasta"], "--pacbio-input", case["bam"],
                 "--output-path", os.path.join(case["dir"], "nocard"),
                 "--output-file", os.path.join(case["dir"], "nocard.vapor"),
                 "--device", "cuda", "--no-figures"]) == 2
