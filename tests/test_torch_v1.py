"""vapor_tpu_torch's v1 dense engine (engine/kernel.py, --backend
torch-v1) on the CPU against vapor_tpu's v1 engine and the numpy oracle:
the decoded per-row integers of every device mode equal exactly, the
three scorers' scores equal as floats, and the CLI reproduces every
golden of fixtures/golden/ byte for byte."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vapor_tpu.engine import kernel as jk
from vapor_tpu.engine import oracle
from vapor_tpu_torch.engine import kernel as tk
from vapor_tpu_torch.engine.scoring import get_backend
from vapor_tpu_torch.sim import goldens
from test_kernel_vs_oracle import _scenarios

torch.set_num_threads(1)      # the suite runs several processes at once

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
COMP = np.zeros(256, dtype=np.uint8)
COMP[ACGT] = np.frombuffer(b"TGCA", dtype=np.uint8)
# the scenarios whose haps and reads all fall in the H = R = 512 bucket
# (DEL, INV, DUP, no SV and the N/IUPAC/lower-case edge case): one shape
# per device mode for the JAX engine
JAX_SCENARIOS = (1, 2, 4, 5, 6, 8)


def _rows(seed, H, R, B, extreme=False):
    """Seeded inputs of one pass: a random hap of 0.8 H bases, reads cut
    from it with 5% substitutions (every third one reverse-complemented,
    the fourth a palindrome), both or_modes, nonzero z and random keep
    tables.  `extreme`: every even read is a 60-base cut near the hap's
    end with m just below it, the largest m a hit can have."""
    rng = np.random.default_rng(seed)
    WH, _, _ = tk._hist_layout(H, R)
    hl = int(0.8 * H)
    body = rng.choice(ACGT, hl)
    hap = np.full(H, tk.HAP_PAD, dtype=np.uint8)
    hap[:hl] = body
    fw = np.full((B, R), tk.READ_PAD, dtype=np.uint8)
    rc = fw.copy()
    rlens = np.zeros(B, dtype=np.int32)
    ms = np.zeros(B, dtype=np.int32)
    for b in range(B):
        if extreme and b % 2 == 0:
            start, n = hl - 70, 60
            ms[b] = start - 5
        else:
            n = int(rng.integers(R // 4, R - 1))
            start = int(rng.integers(0, max(1, hl - n)))
            ms[b] = int(rng.integers(0, 30))
        r = body[start:start + n].copy()
        if b % 3 == 1:
            r = COMP[r[::-1]]
        if b == 3:                         # its own reverse complement
            half = r[: len(r) // 2]
            r = np.concatenate([half, COMP[half][::-1]])
        sub = rng.random(len(r)) < 0.05
        r[sub] = rng.choice(ACGT, int(sub.sum()))
        fw[b, : len(r)] = r
        rc[b, : len(r)] = COMP[r][::-1]
        rlens[b] = len(r)
    return (hap, fw, rc, rlens, ms, rng.random((B, WH)) < 0.7,
            rng.random((B, WH)) < 0.7,
            (np.arange(B) % 2).astype(np.int32),
            rng.integers(-60, 60, B).astype(np.int32))


def _both(args, k, H, R, mode, use_masks):
    """(vapor_tpu's HapStats, ours) of one pass on the same inputs."""
    theirs = jk.HapStats(*jk._dot_stats_batch(
        *(jnp.asarray(a) for a in args), jnp.int32(k), H=H, R=R,
        mode=mode, use_masks=use_masks))
    ours = tk.HapStats(*(x.numpy() for x in tk._dot_stats_batch(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in args), k,
        H=H, R=R, mode=mode, use_masks=use_masks)))
    return theirs, ours


def _assert_equal(theirs, ours):
    for name in tk.STATS + ("h_d", "h_a"):
        want, got = getattr(theirs, name), getattr(ours, name)
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("mode,use_masks", [
    ("hist", False), ("hist", True), ("m1b", True), ("w10", True),
    ("rdd", True), ("all", True)])
def test_hap_stats_equal_jax(mode, use_masks):
    theirs, ours = _both(_rows(1, 512, 512, 6), 10, 512, 512, mode,
                         use_masks)
    _assert_equal(theirs, ours)
    assert (theirs.n_dots > 0).any() or (theirs.cnt > 0).any()


@pytest.mark.parametrize("seed,H,R,k", [(2, 1024, 2048, 20),
                                        (3, 2048, 1024, 10)])
def test_hap_stats_equal_jax_larger_buckets(seed, H, R, k):
    theirs, ours = _both(_rows(seed, H, R, 4), k, H, R, "all", True)
    _assert_equal(theirs, ours)
    assert (theirs.sel_cnt > 0).any() and (theirs.w10 > 0).any()


def test_hap_stats_equal_jax_at_the_extreme_m():
    """m near the hap's end with a short read: the TPU engine's start of
    the reverse diagonal lookup (WH - 1 - D_OFF - C0) goes negative and
    counts from the axis' end, and the reverse diagonal histogram's
    start is clamped; both placements are reproduced."""
    H, R, k = 2048, 512, 10
    args = _rows(4, H, R, 6, extreme=True)
    rlens, ms = args[3], args[4]
    WH, D_OFF, _ = tk._hist_layout(H, R)
    C0 = rlens - k + (H - 1) + ms
    assert ((WH - 1 - D_OFF - C0) < 0).sum() >= 2
    theirs, ours = _both(args, k, H, R, "all", True)
    _assert_equal(theirs, ours)
    # the extreme reads have hits, and some of them survive the masks
    assert (theirs.n_dots[::2] > 0).all() and theirs.cnt[::2].sum() > 0


@pytest.fixture(scope="module")
def backends():
    return get_backend("torch-v1", "cpu"), jk.JaxBackend()


def _floats(rows):
    return [[float(x) for x in r] for r in rows]


@pytest.mark.parametrize("scorer", ["abs_dis_m1b", "within_10perc_m1b",
                                    "redefine_diagonal"])
def test_score_batch_matches_jax_and_oracle(backends, scorer):
    ours, theirs = backends
    nontrivial = 0
    for n, (ref_hap, alt_hap, reads, window) in enumerate(_scenarios()):
        expect = [oracle.SCORERS[scorer](ref_hap, alt_hap, r[0], r[1],
                                         window) for r in reads]
        got = ours.score_batch(scorer, ref_hap, alt_hap, reads, window)
        assert _floats(got) == _floats(expect), n
        if n in JAX_SCENARIOS:
            assert _floats(got) == _floats(theirs.score_batch(
                scorer, ref_hap, alt_hap, reads, window)), n
        nontrivial += sum(1 for e in expect if e != [0, 0])
    assert nontrivial >= 5


def test_palindromic_multiplicity(backends):
    """Palindromic k-mers double-store read positions: a read equal to a
    palindrome-rich hap scores as in vapor_tpu and the oracle."""
    ours, theirs = backends
    seq = "ACGTACGTAATTCCGGAATTACGT" * 8
    reads = [[seq, 0, "p"]]
    for scorer in ("abs_dis_m1b", "within_10perc_m1b", "redefine_diagonal"):
        e = oracle.SCORERS[scorer](seq, seq, seq, 0, 10)
        assert _floats(ours.score_batch(scorer, seq, seq, reads, 10)) == \
            _floats([e]) == \
            _floats(theirs.score_batch(scorer, seq, seq, reads, 10))


def test_large_miss_follows_jax_v1(backends):
    """A read whose miss exceeds R + 1027 + k - rlen: vapor_tpu's v1
    engine moves the start of its reverse-strand diagonal lookup and
    histogram (a negative start counts from the axis' end, then it is
    clamped), so its within-10% count leaves the oracle's.  torch-v1
    keeps vapor_tpu's v1 integers.  The CLI never makes such a read
    (clip_read_to_window drops a read with miss > flank / 2 <= 250)."""
    from vapor_tpu.io.fasta import reverse_complement
    ours, theirs = backends
    rng = np.random.default_rng(3)
    hap = "".join(rng.choice(list("ACGT"), 3000))
    a, n = 1814, 700
    alt = hap[:a] + reverse_complement(hap[a:a + n]) + hap[a + n:]
    reads = [[alt[a - 40:a + n + 10], a - 60, "x"],
             [hap[a - 40:a + n + 10], a - 60, "y"]]
    scorer = "within_10perc_m1b"
    want = theirs.score_batch(scorer, hap, alt, reads, 10)
    assert _floats(ours.score_batch(scorer, hap, alt, reads, 10)) == \
        _floats(want) == [[635, 65], [65, 635]]
    assert oracle.score_within_10perc_m1b(hap, alt, *reads[0][:2], 10) == \
        [635, 66]


def test_oracle_routes(backends):
    """As in vapor_tpu: the legacy scorers and a hap past the largest
    bucket go to the oracle; an unknown scorer raises."""
    ours, _ = backends
    rng = np.random.default_rng(6)
    hap = "".join(rng.choice(list("ACGT"), 300))
    reads = [[hap[20:280], 3, "r"]]
    for scorer in ("abs_dis_m1", "abs_dis_m2"):
        assert ours.score_batch(scorer, hap, hap[:200], reads, 10) == \
            [oracle.SCORERS[scorer](hap, hap[:200], reads[0][0], 3, 10)]
    long_hap = "A" * 16400
    assert ours.score_batch("abs_dis_m1b", long_hap, hap, reads, 10) == \
        [oracle.score_abs_dis_m1b(long_hap, hap, reads[0][0], 3, 10)]
    assert ours.score_batch("abs_dis_m1b", hap, hap, [], 10) == []
    with pytest.raises(ValueError):
        ours.score_batch("directed_m1b", hap, hap, reads, 10)


def test_blocks_cover_the_pass(monkeypatch):
    """Column strips of one read (the layout of the largest buckets on
    the card) give the integers of whole-row blocks."""
    args = _rows(5, 1024, 1024, 3)
    whole = tk.HapStats(*(x.numpy() for x in tk._dot_stats_batch(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in args), 10,
        H=1024, R=1024)))
    monkeypatch.setitem(tk.BLOCK_CELLS, "cpu", 1024 * 300)
    assert tk._blocks(3, 1024, 2047, torch.device("cpu")) == (1, 300)
    strips = tk.HapStats(*(x.numpy() for x in tk._dot_stats_batch(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in args), 10,
        H=1024, R=1024)))
    _assert_equal(whole, strips)


def _repeat_rows(H, R, B, seed):
    """A 2-bp tandem repeat (AC) hap of H - 24 bases and reads cut from
    it at random offsets, with 2% substitutions: every in-phase cell is a
    hit."""
    rng = np.random.default_rng(seed)
    WH, _, _ = tk._hist_layout(H, R)
    hl = H - 24
    body = np.resize(np.frombuffer(b"AC", dtype=np.uint8), hl)
    hap = np.full(H, tk.HAP_PAD, dtype=np.uint8)
    hap[:hl] = body
    fw = np.full((B, R), tk.READ_PAD, dtype=np.uint8)
    rc = fw.copy()
    rlens = np.zeros(B, dtype=np.int32)
    for b in range(B):
        n = int(rng.integers(R // 2, R - 1))
        start = int(rng.integers(0, hl - n))
        r = body[start:start + n].copy()
        sub = rng.random(n) < 0.02
        r[sub] = rng.choice(ACGT, int(sub.sum()))
        fw[b, :n] = r
        rc[b, :n] = COMP[r][::-1]
        rlens[b] = n
    return (hap, fw, rc, rlens, rng.integers(0, 30, B).astype(np.int32),
            rng.random((B, WH)) < 0.7, rng.random((B, WH)) < 0.7,
            (np.arange(B) % 2).astype(np.int32),
            rng.integers(-60, 60, B).astype(np.int32))


def test_tandem_repeat_streams_its_hits(monkeypatch):
    """A tandem-repeat hap has a hit on every in-phase cell: the pass
    sums each block's hits as they come, at most HIT_CHUNK at a time,
    and its integers equal vapor_tpu's."""
    H = R = 1024
    monkeypatch.setitem(tk.BLOCK_CELLS, "cpu", H * 512)
    monkeypatch.setitem(tk.HIT_CHUNK, "cpu", 20000)
    sizes = []
    one = tk._dot_stats_one

    def spy(out, rev, bb, *rest):
        sizes.append(bb.numel())
        one(out, rev, bb, *rest)
    monkeypatch.setattr(tk, "_dot_stats_one", spy)
    theirs, ours = _both(_repeat_rows(H, R, 3, 7), 10, H, R, "all", True)
    _assert_equal(theirs, ours)
    assert theirs.n_dots.sum() > 20 * 20000
    assert max(sizes) <= 20000


def test_hit_cache_stops_at_its_budget(backends, monkeypatch):
    """A hap keeps its hit blocks for its later passes only while they
    total at most HIT_CACHE hits; past it, every pass scans the hap
    again, with the same scores as vapor_tpu's and the oracle's."""
    ours, theirs = backends
    rng = np.random.default_rng(8)
    ref = "AC" * 400
    alt = ref[:300] + "".join(rng.choice(list("ACGT"), 200)) + ref[300:]
    reads = [[alt[s:s + 500], int(rng.integers(0, 20)), f"r{s}"]
             for s in (0, 150, 400)]
    scans = []
    blocks = tk._hit_blocks

    def counted(*args):
        scans.append(1)
        return blocks(*args)
    monkeypatch.setattr(tk, "_hit_blocks", counted)
    for budget, n_scans in ((1 << 30, 4), (1000, 8)):
        monkeypatch.setitem(tk.HIT_CACHE, "cpu", budget)
        scans.clear()
        got = ours.score_batch("abs_dis_m1b", ref, alt, reads, 10)
        assert len(scans) == n_scans    # 2 haps x 2 strands, x 2 passes
        want = [oracle.score_abs_dis_m1b(ref, alt, r[0], r[1], 10)
                for r in reads]
        assert _floats(got) == _floats(want) == _floats(
            theirs.score_batch("abs_dis_m1b", ref, alt, reads, 10))
        assert any(w != [0, 0] for w in want)


@pytest.mark.parametrize("name", sorted(goldens.BUILDERS))
def test_golden_through_torch_v1(name, tmp_path):
    assert goldens.run_golden(name, str(tmp_path), "torch-v1", "cpu") == \
        goldens.golden_text(name)


def test_torch_v1_refines_on_its_device(tmp_path):
    """The v1 backend gets the device window refiner, unbatched, on the
    backend's device (as vapor_tpu gives jax-v1 its refiner)."""
    from vapor_tpu_torch.validators import ValidatorContext
    case = goldens.BUILDERS["bed_del_11"](str(tmp_path))
    ctx = ValidatorContext(case["fasta"], case["bam"], backend="torch-v1",
                           device="cpu")
    assert ctx.backend.name == "torch-v1"
    assert ctx._refiner is not None and ctx._refiner._submit is None
    assert ctx._refiner.device == ctx.backend.device


def test_torch_v1_without_card_exits_non_zero(tmp_path, capsys):
    from vapor_tpu_torch.cli import main
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        get_backend("torch-v1")
    d = str(tmp_path)
    case = goldens.BUILDERS["bed_del_11"](d)
    out = tmp_path / "x.vapor"
    assert main(["bed", "--sv-input", case["bed"], "--reference",
                 case["fasta"], "--pacbio-input", case["bam"],
                 "--output-path", d, "--output-file", str(out),
                 "--backend", "torch-v1", "--no-figures"]) != 0
    assert "CUDA" in capsys.readouterr().err
    assert not out.exists()
