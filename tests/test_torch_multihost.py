"""The port's multi-process sharding (vapor_tpu_torch/parallel/multihost.py
on torch.distributed with gloo): tests/test_multihost.py's ten cases, each
also held equal to vapor_tpu's function on the same events; a two-rank
gloo run of the bed CLI on the CPU against the single run; and vcf
mode's one owner over every SV type."""
import os
import socket
import subprocess
import sys

import pytest

from vapor_tpu.cli import main as jax_main
from vapor_tpu.parallel import multihost as jmh
from vapor_tpu.sim.scale import build_scale_case
from vapor_tpu_torch import cli as tcli
from vapor_tpu_torch.parallel import multihost as tmh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIST_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
            "MASTER_PORT")


def _shards(mod, events, n, owner=None):
    return [mod.shard_worklist(events, p, n, owner=owner) for p in range(n)]


def test_initialize_standalone(monkeypatch):
    for name in DIST_ENV:
        monkeypatch.delenv(name, raising=False)
    assert tmh.initialize() == jmh.initialize() == (0, 1)
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert tmh.initialize() == (0, 1)
    assert tmh.rank_device("cpu") == "cpu"


@pytest.mark.parametrize("env,several", [
    ({}, False), ({"WORLD_SIZE": "1"}, False), ({"WORLD_SIZE": "2"}, True),
    ({"LOCAL_WORLD_SIZE": "1"}, False), ({"LOCAL_WORLD_SIZE": "3"}, True)])
def test_rank_device_takes_one_card_per_process(monkeypatch, env, several):
    """On 2 (patched) cards, local ranks 0-3 take cards 0, 1, 0, 1; a
    process is one of several under torchrun's WORLD_SIZE > 1 or a
    scatter shard's LOCAL_WORLD_SIZE > 1.  Without a card "cuda" stays
    "cuda", which the backend refuses."""
    import torch
    for name in DIST_ENV + ("LOCAL_WORLD_SIZE",):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    assert tmh.one_of_several() is several
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    got = []
    for rank in range(4):
        monkeypatch.setenv("LOCAL_RANK", str(rank))
        got.append(tmh.rank_device("cuda"))
    assert got == ["cuda:0", "cuda:1", "cuda:0", "cuda:1"]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert tmh.rank_device("cuda") == "cuda"


def test_shard_worklist_contig_granular():
    events = [(f"chr{c}", i) for c in (1, 2, 3, 4) for i in range(3)]
    shards = _shards(tmh, events, 2)
    assert shards == _shards(jmh, events, 2)
    assert sorted(shards[0] + shards[1]) == sorted(events)
    assert not ({e[0] for e in shards[0]} & {e[0] for e in shards[1]})


def test_shard_worklist_roundrobin_fallback():
    events = [("chr1", i) for i in range(10)]
    shards = _shards(tmh, events, 4)
    assert shards == _shards(jmh, events, 4)
    assert sorted(sum(shards, [])) == sorted(events)
    assert max(len(s) for s in shards) - min(len(s) for s in shards) <= 1


def test_contig_owner_shared_across_types():
    dels = [("chr1", i) for i in range(6)] + [("chr2", 0)]
    invs = [("chr2", i) for i in range(6)] + [("chr1", 0)]
    owner = tmh.contig_owner(dels + invs, 2)
    assert owner == jmh.contig_owner(dels + invs, 2)
    assert set(owner) == {"chr1", "chr2"}
    for typed in (dels, invs):
        for p in range(2):
            got = tmh.shard_worklist(typed, p, 2, owner=owner)
            assert got == jmh.shard_worklist(typed, p, 2, owner=owner)
            assert all(owner[e[0]] == p for e in got)


def test_contig_of_event_unwraps_blocks():
    for e in ([["chr7", 100, 200], ["chr7", 250, 300]], ("chr3", 5, 10)):
        assert tmh.contig_of_event(e) == jmh.contig_of_event(e)
    assert tmh.contig_of_event([["chr7", 100, 200], ["chr7", 250, 300]]) \
        == "chr7"


def test_allgather_rows_single_process():
    rows = [["chr1", "1", "x"], ["chr2", "2", "y"]]
    assert tmh.allgather_rows(rows) == jmh.allgather_rows(rows) == rows


def test_balanced_owner_splits_dominant_contig():
    events = [("chr1", 1000 * i, 1000 * i + 500) for i in range(30)] \
        + [("chr2", 1000 * i, 1000 * i + 500) for i in range(3)]
    shards = _shards(tmh, events, 2, tmh.balanced_owner(events, 2))
    assert shards == _shards(jmh, events, 2, jmh.balanced_owner(events, 2))
    assert sorted(shards[0] + shards[1]) == sorted(events)
    assert min(len(s) for s in shards) >= 12
    for s in shards:
        idx = sorted(e[1] // 1000 for e in s if e[0] == "chr1")
        assert 1 + sum(1 for a, b in zip(idx, idx[1:]) if b != a + 1) <= 3


def test_balanced_owner_cost_variance_across_equal_counts():
    events = []
    for c in range(8):
        span = 200 if c < 7 else 5000
        events += [(f"chr{c}", 2000 * i, 2000 * i + span)
                   for i in range(25)]
    shards = _shards(tmh, events, 8, tmh.balanced_owner(events, 8))
    assert shards == _shards(jmh, events, 8, jmh.balanced_owner(events, 8))
    assert [tmh.event_cost(e) for e in events] == \
        [jmh.event_cost(e) for e in events]
    loads = [sum(tmh.event_cost(e) for e in s) for s in shards]
    assert max(loads) <= 1.15 * sum(loads) / 8


def test_balanced_owner_keeps_contig_granularity_when_balanced():
    events = [(f"chr{c}", 100 * i, 100 * i + 50)
              for c in (1, 2, 3, 4) for i in range(5)]
    shards = _shards(tmh, events, 2, tmh.balanced_owner(events, 2))
    assert shards == _shards(jmh, events, 2, jmh.balanced_owner(events, 2))
    c0, c1 = ({e[0] for e in s} for s in shards)
    assert not (c0 & c1) and len(c0) == len(c1) == 2


def test_shard_worklist_deterministic_partition():
    events = [(f"chr{c}", 977 * i % 9000, 977 * i % 9000 + 100 + 37 * i)
              for c in (1, 2, 3) for i in range(11)]
    a = _shards(tmh, events, 4, tmh.balanced_owner(events, 4))
    b = _shards(tmh, list(events), 4, tmh.balanced_owner(list(events), 4))
    assert a == b == _shards(jmh, events, 4, jmh.balanced_owner(events, 4))
    assert sorted(sum(a, [])) == sorted(events)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dist"))
    case = build_scale_case(d, n_contigs=3, contig_len=30000, events_per=2,
                            reads_per=6, n_false_per=0, seed=9)
    case["dir"] = d
    return case


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _bed_args(case, out, figs):
    return ["bed", "--sv-input", case["bed"], "--reference", case["fasta"],
            "--pacbio-input", case["bam"], "--output-path", figs,
            "--output-file", out, "--device", "cpu", "--no-figures"]


def _rows(path):
    with open(path) as fh:
        return [x.split("\t") for x in fh
                if not x.startswith("#") and x.strip()]


def test_two_rank_gloo_run_matches_single(case):
    """Two ranks with torchrun's environment join a gloo group, score
    disjoint shards on the CPU and rank 0 writes the single run's
    bytes."""
    d = case["dir"]
    single = os.path.join(d, "single.vapor")
    assert tcli.main(_bed_args(case, single, os.path.join(d, "f"))) == 0
    out = os.path.join(d, "dist.vapor")
    port = _free_port()
    base = {k: v for k, v in os.environ.items() if k not in DIST_ENV}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "vapor_tpu_torch",
         *_bed_args(case, out, os.path.join(d, f"f{rank}"))],
        cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True, env=dict(base, RANK=str(rank), LOCAL_RANK=str(rank),
                            WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                            MASTER_PORT=str(port), OMP_NUM_THREADS="2"))
        for rank in range(2)]
    try:
        errs = [p.communicate(timeout=300)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], errs
    with open(out, "rb") as got, open(single, "rb") as want:
        assert got.read() == want.read()
    # each rank's rows are vapor_tpu's balanced_owner shard of the calls
    # (contig-granular, or contiguous blocks of a contig where whole
    # contigs would leave the ranks unbalanced): disjoint, both non-empty
    from vapor_tpu_torch.io.parsers import bed_info_readin
    events = bed_info_readin(case["bed"])
    owner = jmh.balanced_owner(events, 2)
    for rank in range(2):
        rows = _rows(f"{out}.shard{rank}")
        assert rows
        assert [tuple(r[:2]) for r in rows] == [
            (e[0], str(e[1])) for e in jmh.shard_worklist(
                events, rank, 2, owner=owner)]
    assert len(_rows(out + ".shard0")) + len(_rows(out + ".shard1")) == \
        len(_rows(single))


def test_vcf_shards_share_one_owner(case, monkeypatch, tmp_path):
    """vcf mode takes one balanced_owner over every SV type's events:
    with DELs heavy on chr1 and INVs heavy on chr2, owners taken per type
    would send some region's DEL and INV calls to different shards.
    Each shard's rows are the calls the combined owner gives it, and
    equal vapor_tpu's."""
    import vapor_tpu.cli as jcli
    from vapor_tpu_torch.io.parsers import vcf_list_readin
    calls = [("chr1", 25142, 25733, "DEL"), ("chr1", 4000, 4300, "DEL"),
             ("chr1", 16000, 16400, "DEL"), ("chr2", 21018, 21714, "DEL"),
             ("chr2", 14073, 14340, "INV"), ("chr2", 3000, 3250, "INV"),
             ("chr2", 26000, 26300, "INV"), ("chr1", 9457, 9713, "INV"),
             ("chr3", 4381, 4933, "DEL"), ("chr3", 20818, 21226, "INV")]
    text = ("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
            "FILTER\tINFO\tFORMAT\tS1\n" + "".join(
                f"{c}\t{s + 1}\tsv{i}\tN\t<{t}>\t99\tPASS\t"
                f"SVTYPE={t};END={e}\tGT\t0/1\n"
                for i, (c, s, e, t) in enumerate(calls)))
    for mod in (tcli, jcli):
        monkeypatch.setattr(mod, "annotate_vcf", lambda *a, **k: None)
    shards = {}
    for tag, run, extra in (("t", tcli.main, ["--device", "cpu"]),
                            ("j", jax_main, ["--backend", "numpy"])):
        for index in range(2):
            vcf = tmp_path / f"{tag}{index}.vcf"
            vcf.write_text(text)
            assert run(["vcf", "--sv-input", str(vcf), "--reference",
                        case["fasta"], "--pacbio-input", case["bam"],
                        "--output-path", str(tmp_path / "figs"),
                        "--no-figures", "--shard-by-contig",
                        "--num-shards", "2", "--shard-index", str(index),
                        *extra]) == 0
            shards[tag, index] = _rows(f"{vcf}.vapor")
    vcf_list, _ = vcf_list_readin(str(tmp_path / "t0.vcf"))
    typed = {t: [y for y in vcf_list[t] if "NA" not in y]
             for t in ("DEL", "INV")}
    owner = jmh.balanced_owner(typed["DEL"] + typed["INV"], 2)
    per_type = {t: jmh.balanced_owner(ys, 2) for t, ys in typed.items()}
    assert any(owner.host_of(y) != per_type[t].host_of(y)
               for t, ys in typed.items() for y in ys)
    for index in range(2):
        assert shards["t", index] == shards["j", index]
        assert sorted(r[0] for r in shards["t", index]) == sorted(
            ":".join(str(x) for x in y) + f":{t}"
            for t, ys in typed.items() for y in ys
            if owner.host_of(y) == index)
    assert all(shards["t", i] for i in range(2))
    assert sum(len(shards["t", i]) for i in range(2)) == len(calls)
