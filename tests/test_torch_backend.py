"""vapor_tpu_torch's FusedBackend on the CPU against vapor_tpu's
FusedBackend and the numpy oracle: the scores must be equal as floats."""
import random

import numpy as np
import pytest
import torch

from vapor_tpu.engine import oracle
from vapor_tpu.engine.fused import FusedBackend as JaxBackend
from vapor_tpu_torch.engine.fused import FusedBackend
from vapor_tpu_torch.engine.scoring import NumpyBackend, get_backend
from test_fused_vs_oracle import _mutate, _scenarios


# the DEL, INV and no-SV scenarios: one (H, R, rows) shape for the JAX
# engine, so it compiles once per mode (the oracle takes every scenario)
JAX_SCENARIOS = (0, 1, 2, 3, 6, 7)
DUP_SCENARIOS = (4, 5)
torch.set_num_threads(1)      # the suite runs several processes at once


@pytest.fixture(scope="module")
def backends():
    return FusedBackend("cpu"), JaxBackend()


def _floats(rows):
    return [[float(x) for x in r] for r in rows]


@pytest.mark.parametrize("scorer", ["abs_dis_m1b", "within_10perc_m1b"])
def test_score_batch_matches_jax_and_oracle(backends, scorer):
    ours, theirs = backends
    nontrivial = 0
    for n, (ref_hap, alt_hap, reads, window) in enumerate(_scenarios()):
        expect = [oracle.SCORERS[scorer](ref_hap, alt_hap, r[0], r[1],
                                         window) for r in reads]
        got = ours.score_batch(scorer, ref_hap, alt_hap, reads, window)
        assert _floats(got) == _floats(expect)
        if n in JAX_SCENARIOS:
            assert _floats(got) == _floats(theirs.score_batch(
                scorer, ref_hap, alt_hap, reads, window))
        nontrivial += sum(1 for e in expect if e != [0, 0])
    assert nontrivial >= 5


def test_score_del_batch_matches_jax_and_oracle(backends):
    ours, theirs = backends
    rng = random.Random(77)
    checked = 0
    for trial in range(4):
        flank = 120                # one (H, R) shape for the JAX engine
        body = "".join(rng.choice("ACGT") for _ in range(200))
        left = "".join(rng.choice("ACGT") for _ in range(flank))
        right = "".join(rng.choice("ACGT") for _ in range(flank))
        ref_hap = left + body + right
        if trial == 3:             # raw and upper-cased haps differ
            ref_hap = ref_hap[:50].lower() + ref_hap[50:]
        alt_hap = left + right
        reads = [[_mutate(alt_hap if i % 2 == 0 else ref_hap, rng, 0.08),
                  rng.choice([0, 11]), f"r{i}"] for i in range(6)]
        m1b, w10 = ours.score_del_batch(ref_hap, alt_hap, reads, 10)
        j_m1b, j_w10 = theirs.score_del_batch(ref_hap, alt_hap, reads, 10)
        assert _floats(m1b) == _floats(j_m1b)
        assert _floats(w10) == _floats(j_w10)
        for r, g1, g2 in zip(reads, m1b, w10):
            e1 = oracle.score_abs_dis_m1b(ref_hap, alt_hap, r[0], r[1], 10)
            e2 = oracle.score_within_10perc_m1b(ref_hap, alt_hap, r[0],
                                                r[1], 10)
            assert _floats([g1, g2]) == _floats([e1, e2])
            checked += (e1 != [0, 0]) + (e2 != [0, 0])
    assert checked >= 6


def test_oracle_fallbacks_match(backends):
    """Bytes outside the engine alphabet and haps past the largest bucket
    are scored by the oracle, as in vapor_tpu."""
    ours, _ = backends
    rng = random.Random(5)
    hap = "".join(rng.choice("ACGT") for _ in range(300))
    odd = hap[:100] + "é" + hap[101:]
    reads = [[hap[20:280], 0, "r"]]
    for ref in (odd, "A" * 16400):
        for scorer in ("abs_dis_m1b", "within_10perc_m1b"):
            assert ours.score_batch(scorer, ref, hap, reads, 10) == \
                [oracle.SCORERS[scorer](ref, hap, reads[0][0], 0, 10)]


def test_redefine_diagonal_raises(backends):
    """redefine_diagonal (device mode rdd) runs, even on no reads; a
    scorer the engine does not know raises."""
    ours, _ = backends
    assert ours.score_batch_async("redefine_diagonal", "A", "C", [], 10)() \
        == []
    with pytest.raises(KeyError):
        ours.score_batch("redefine_diagonal2", "ACGT" * 50, "ACGT" * 60,
                         [["ACGT" * 40, 0, "r"]], 10)


def test_redefine_diagonal_matches_jax_and_oracle(backends):
    """redefine_diagonal scores equal vapor_tpu's FusedBackend and the
    oracle over every scenario, the DUP ones included."""
    ours, theirs = backends
    scorer = "redefine_diagonal"
    nontrivial = 0
    for n, (ref_hap, alt_hap, reads, window) in enumerate(_scenarios()):
        expect = [oracle.SCORERS[scorer](ref_hap, alt_hap, r[0], r[1],
                                         window) for r in reads]
        got = ours.score_batch(scorer, ref_hap, alt_hap, reads, window)
        assert _floats(got) == _floats(expect), n
        if n in JAX_SCENARIOS + DUP_SCENARIOS:
            assert _floats(got) == _floats(theirs.score_batch(
                scorer, ref_hap, alt_hap, reads, window)), n
        nontrivial += sum(1 for e in expect if e != [0, 0])
    assert nontrivial >= 5


def test_redefine_diagonal_on_dup_haps_matches_oracle(backends):
    """Tandem-DUP rows with lower-case stretches: rdd scores the raw haps
    (no upper-casing), as vapor_tpu and the oracle do."""
    ours, _ = backends
    rng = random.Random(91)
    checked = 0
    for trial in range(3):
        left = "".join(rng.choice("ACGT") for _ in range(150))
        body = "".join(rng.choice("ACGT") for _ in range(220))
        right = "".join(rng.choice("ACGT") for _ in range(150))
        if trial == 2:
            body = body[:60].lower() + body[60:]
        ref_hap, alt_hap = left + body + right, left + body * 2 + right
        reads = [[_mutate(alt_hap if i % 2 == 0 else ref_hap, rng, 0.06),
                  rng.choice([0, 17]), f"r{i}"] for i in range(6)]
        got = ours.score_batch("redefine_diagonal", ref_hap, alt_hap,
                               reads, 10)
        for g, r in zip(got, reads):
            e = oracle.score_redefine_diagonal(ref_hap, alt_hap, r[0], r[1],
                                               10)
            assert _floats([g]) == _floats([e])
            checked += e != [0, 0]
    assert checked >= 6


def test_large_miss_matches_oracle(backends):
    """An INV read whose miss (1,754) lies past R + 1027 + k - rlen, where
    vapor_tpu's v1 engine (jax-v1) moves its reverse-strand diagonal
    starts: both fused engines keep the oracle's within-10% counts."""
    from vapor_tpu.io.fasta import reverse_complement
    ours, theirs = backends
    rng = np.random.default_rng(3)
    hap = "".join(rng.choice(list("ACGT"), 3000))
    a, n = 1814, 700
    alt = hap[:a] + reverse_complement(hap[a:a + n]) + hap[a + n:]
    reads = [[alt[a - 40:a + n + 10], a - 60, "x"],
             [hap[a - 40:a + n + 10], a - 60, "y"]]
    want = [oracle.score_within_10perc_m1b(hap, alt, r[0], r[1], 10)
            for r in reads]
    assert want == [[635, 66], [65, 635]]
    for backend in (ours, theirs):
        got = backend.score_batch("within_10perc_m1b", hap, alt, reads, 10)
        assert _floats(got) == _floats(want)


def test_get_backend_names():
    from vapor_tpu_torch.engine.batching import BatchingBackend
    assert isinstance(get_backend("numpy"), NumpyBackend)
    assert get_backend("torch", "cpu").device.type == "cpu"
    assert type(get_backend("torch", "cpu")) is BatchingBackend
    assert type(get_backend("torch-nobatch", "cpu")) is FusedBackend
    from vapor_tpu_torch.engine.kernel import V1Backend
    v1 = get_backend("torch-v1", "cpu")
    assert type(v1) is V1Backend and v1.name == "torch-v1"
    assert v1.device.type == "cpu"
    with pytest.raises(ValueError):
        get_backend("jax")
