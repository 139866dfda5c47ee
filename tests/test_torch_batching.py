"""vapor_tpu_torch's BatchingBackend on the CPU: the grouped cross-event
launches give the scores of the unbatched FusedBackend and of vapor_tpu's
BatchingBackend exactly, sequentially, under concurrent submission,
in bursts, with the window refiner's self-stats requests in the same
flushes, across _row_cap splits and many distinct haps; a failing launch
reaches its caller as an exception (the mirror of tests/test_batching.py).
"""
import random
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from vapor_tpu.engine.batching import BatchingBackend as JaxBatching
from vapor_tpu_torch.engine import batching
from vapor_tpu_torch.engine.batching import BatchingBackend
from vapor_tpu_torch.engine.constants import HAP_PAD
from vapor_tpu_torch.engine.fused import FusedBackend
from vapor_tpu_torch.engine.window_device import self_stats_rows
from test_batching import SCORERS, _make_event

SCORERS_MODES = ("m1b", "w10", "rdd")     # SCORERS' device modes

torch.set_num_threads(1)      # the suite runs several processes at once


@pytest.fixture(scope="module")
def events():
    """test_batching.py's events (the same seed)."""
    rng = random.Random(20260818)
    return [_make_event(rng, rng.choice([300, 400, 900]),
                        rng.randrange(2, 8)) for _ in range(10)]


@pytest.fixture(scope="module")
def jax_batching():
    return JaxBatching()


@pytest.fixture
def bat():
    return BatchingBackend("cpu")


def _recording(be):
    """Wraps be._flush and be._launch to record each flush's request
    keys and each launch's (key, rows)."""
    flushes, launches = [], []
    flush, launch = be._flush, be._launch

    def rec_flush(batch):
        flushes.append([r.key for r in batch])
        return flush(batch)

    def rec_launch(key, sub):
        launches.append((key, sum(r.B for r in sub)))
        return launch(key, sub)

    be._flush, be._launch = rec_flush, rec_launch
    return flushes, launches


def test_batched_equals_unbatched_sequential(events, bat, jax_batching):
    base = FusedBackend("cpu")
    for i, (ref, alt, reads) in enumerate(events):
        scorer = SCORERS[i % len(SCORERS)]
        w = [10, 20][i % 2]
        got = bat.score_batch(scorer, ref, alt, reads, w)
        assert got == base.score_batch(scorer, ref, alt, reads, w)
        assert got == jax_batching.score_batch(scorer, ref, alt, reads, w)


def test_batched_equals_unbatched_concurrent(events, bat, jax_batching):
    base = FusedBackend("cpu")
    jobs = [(SCORERS[i % len(SCORERS)], ev, [10, 20][i % 3 == 0])
            for i, ev in enumerate(events)]

    def run(be, job):
        scorer, (ref, alt, reads), w = job
        return be.score_batch(scorer, ref, alt, reads, w)

    with ThreadPoolExecutor(max_workers=6) as pool:
        got = list(pool.map(lambda j: run(bat, j), jobs))
    assert got == [run(base, j) for j in jobs]
    assert got == [run(jax_batching, j) for j in jobs]


def test_batched_del_mode(events, bat, jax_batching):
    base = FusedBackend("cpu")
    for ref, alt, reads in events[:4]:
        # a lower-case tail: the raw haps are submitted beside the
        # upper-cased ones
        ref_l = ref[:-40] + ref[-40:].lower()
        got = bat.score_del_batch(ref_l, alt, reads, 10)
        assert got == base.score_del_batch(ref_l, alt, reads, 10)
        assert got == jax_batching.score_del_batch(ref_l, alt, reads, 10)


def test_async_burst(events, jax_batching):
    """Every event dispatched before any finisher resolves (the
    breadth-first pipeline's pattern), then resolved after each
    dispatch in a second burst."""
    base = FusedBackend("cpu")
    jobs = [(SCORERS[i % len(SCORERS)], ev, 10)
            for i, ev in enumerate(events)]
    want = [base.score_batch(s, ref, alt, reads, w)
            for s, (ref, alt, reads), w in jobs]
    assert want == [jax_batching.score_batch(s, ref, alt, reads, w)
                    for s, (ref, alt, reads), w in jobs]
    be = BatchingBackend("cpu")
    fins = [be.score_batch_async(s, ref, alt, reads, w)
            for s, (ref, alt, reads), w in jobs]
    assert [fin() for fin in fins] == want
    got = []
    for s, (ref, alt, reads), w in jobs:
        got.append(be.score_batch_async(s, ref, alt, reads, w)())
    assert got == want


def test_selfstats_and_scores_share_a_flush(events):
    """Refiner requests and score requests submitted together land in one
    flush; each self-stats row equals self_stats_rows on its own."""
    be = BatchingBackend("cpu")
    flushes, _ = _recording(be)
    base = FusedBackend("cpu")
    rng = random.Random(8)
    body = "".join(rng.choice("ACGT") for _ in range(120))
    seqs = [events[0][0], body * 3, events[1][1][:200]]
    fins = []
    for i, (ref, alt, reads) in enumerate(events[:3]):
        fins.append(be.score_batch_async(SCORERS[i], ref, alt, reads, 10))
    rows = []
    for seq in seqs:
        hap = base._encode_hap(seq, 1024)
        rows.append((hap, len(seq),
                     be.submit_selfstats(hap, len(seq), 20, 1024)))
    for i, (ref, alt, reads) in enumerate(events[:3]):
        assert fins[i]() == base.score_batch(SCORERS[i], ref, alt, reads,
                                             10)
    for hap, n, fut in rows:
        want = self_stats_rows(torch.from_numpy(hap[None]),
                               torch.tensor([n], dtype=torch.int32), 20)[0]
        assert fut.result(timeout=60).tolist() == want.tolist()
    assert len(flushes) == 1
    assert {key[2] for key in flushes[0]} == {*SCORERS_MODES, "selfstats"}


def test_flush_splits_at_row_cap(events, monkeypatch):
    """A cell budget of 16 rows at every shape: a group of more rows
    splits into several launches, the scores unchanged."""
    assert batching._row_cap(512, 512) == 2048
    monkeypatch.setattr(batching, "CELL_BUDGET", 1)
    assert batching._row_cap(1024, 1024) == 16
    be = BatchingBackend("cpu")
    _, launches = _recording(be)
    base = FusedBackend("cpu")
    ref, alt, reads = events[2]
    many = (reads * 8)[:30]
    fins = [be.score_batch_async("abs_dis_m1b", ref, alt, many, 10)
            for _ in range(2)]
    want = base.score_batch("abs_dis_m1b", ref, alt, many, 10)
    assert [fin() for fin in fins] == [want, want]
    assert all(rows <= 30 for _, rows in launches)
    by_key = {}
    for key, rows in launches:
        by_key.setdefault(key, []).append(rows)
    assert any(len(v) > 1 and sum(v) > 16 for v in by_key.values())


def test_many_distinct_haps_in_one_group():
    """40 events of one (H, R) bucket, each with its own haps: one group
    of 80 distinct hap rows, every row's score unchanged."""
    rng = random.Random(31)
    evs = []
    for _ in range(40):
        ref = "".join(rng.choice("ACGT") for _ in range(400))
        alt = ref[:150] + ref[250:]
        evs.append((ref, alt, [[ref[:300], 0, "r0"], [alt[20:280], 7,
                                                      "r1"]]))
    be = BatchingBackend("cpu")
    _, launches = _recording(be)
    base = FusedBackend("cpu")
    fins = [be.score_batch_async("within_10perc_m1b", *ev, 10)
            for ev in evs]
    got = [fin() for fin in fins]
    assert got == [base.score_batch("within_10perc_m1b", *ev, 10)
                   for ev in evs]
    assert max(rows for _, rows in launches) >= 40


def test_failing_launch_raises(bat):
    """A malformed request raises from result(), never hangs, and fails
    only its own group: the flush's other requests and later ones are
    served."""
    hap = np.full(512, HAP_PAD, np.uint8)
    hap[:300] = np.frombuffer(b"ACGT", np.uint8)[
        np.random.default_rng(3).integers(0, 4, 300)]
    enc = (np.zeros((2, 128), np.uint8), np.ones(2, np.int32),
           np.zeros(2, np.int32))
    fut = bat._submit(None, enc, 10, 128, 128, "m1b")
    ok = bat.submit_selfstats(hap, 300, 10, 512)
    with pytest.raises(AttributeError):
        fut.result(timeout=30)
    with pytest.raises(AttributeError):
        fut.result(timeout=30)
    assert ok.result(timeout=30).tolist() == [291, 291, 0]
    assert bat.submit_selfstats(hap, 300, 20, 512).result(
        timeout=30).tolist() == [281, 281, 0]


def test_threads_racing_for_flushes():
    """16 threads submit self-stats requests and read them back at once,
    with a short switch interval: every request is launched exactly once
    and gets its own row."""
    import sys
    rng = np.random.default_rng(12)
    haps, lengths = [], []
    for n in rng.integers(40, 500, 64):
        hap = np.full(512, HAP_PAD, np.uint8)
        hap[:n] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)]
        if n > 200:      # a tandem block, so rows differ in "below"
            hap[100:190] = np.tile(hap[10:40], 3)
        haps.append(hap)
        lengths.append(int(n))
    want = self_stats_rows(torch.from_numpy(np.stack(haps)),
                           torch.tensor(lengths, dtype=torch.int32),
                           10).tolist()
    be = BatchingBackend("cpu")
    _, launches = _recording(be)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=16) as pool:
            got = list(pool.map(
                lambda i: be.submit_selfstats(haps[i], lengths[i], 10,
                                              512).result(timeout=60)
                .tolist(), range(64)))
    finally:
        sys.setswitchinterval(old)
    assert got == want
    assert sum(rows for _, rows in launches) == 64
