"""vapor_tpu_torch's CUDA kernels against their plain PyTorch versions
(the window refiner's self-stats rows through hist included, and the
three glue kernels: row_codes, kept_tables, intercept_z), each
kernel's device time apart from host work within its call time, the fused
engine on the card against the same engine on the CPU, its rows split
over two streams of the card against one launch, the batching
backend on the card against the unbatched one, the device window
refiner on the refiner-band census haps against the host refiner, and
three goldens of fixtures/golden/ through the CLI on the card.

Needs a CUDA card and nvcc: each test skips without one.  Run on the
card with  python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import functools
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from vapor_tpu_torch.engine import kernels
from vapor_tpu_torch.engine.kernels import timing
from vapor_tpu_torch.engine.constants import HAP_PAD, READ_PAD
from vapor_tpu_torch.engine.fused import (batch_from_numpy, fused_batch,
                                          fused_batch_local, intercept_z,
                                          kept_table, row_codes)
from vapor_tpu_torch.parallel.mesh import maybe_mesh_rows
from vapor_tpu_torch.sim.worklists import repeat_rows
from torch_rows import random_rows

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _batch(H, R, B, seed):
    """random_rows with varied m and, last, a pad row (rlen 1, m 0) as
    fused_batch appends."""
    haps, reads, rlens, ms = random_rows(H, R, B, seed, ms=(0, 23, 0, 140))
    rlens[-1], ms[-1] = 1, 0
    reads[-1] = READ_PAD
    return haps, reads, rlens, ms


@pytest.mark.parametrize("H,R", [(512, 512), (1536, 1024), (1024, 2048)])
@pytest.mark.parametrize("k", [10, 20, 30, 40])
def test_kernels_equal_plain(cuda, H, R, k):
    haps, reads, rlens, ms = _batch(H, R, 6, seed=H + R + k)
    h, r, rl, m, _ = batch_from_numpy(haps, reads, rlens, ms, k // 10 - 1,
                                      cuda)
    codes = (*row_codes(h, r, rl, k), m, rl, k)
    launched = dict(kernels.LAUNCHES)
    got = kernels.hist(*codes)
    want = kernels.hist_plain(*codes)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    kd, ka = (kept_table(x, 10, 10, False, H, R) for x in want[:2])
    kd50 = kept_table(want[0], 10, 50, True, H, R)
    left = kernels.left_hist(*codes, kd50)
    assert torch.equal(left, kernels.left_hist_plain(*codes, kd50))
    ka50 = kept_table(left, 10, 50, True, H, R)
    for keep, w10 in (((kd, ka), False), ((kd50, ka50), True)):
        assert torch.equal(kernels.moment(*codes, *keep, w10),
                           kernels.moment_plain(*codes, *keep, w10))
    assert torch.equal(kernels.moment2(*codes, kd, ka, kd50, ka50),
                       kernels.moment2_plain(*codes, kd, ka, kd50, ka50))
    h_kept = kernels.kept_hist(*codes, kd, ka)
    assert torch.equal(h_kept, kernels.kept_hist_plain(*codes, kd, ka))
    found, z = intercept_z(h_kept, H, R)
    z = torch.where(found, z + 2 * m, 0).to(torch.int32)
    assert torch.equal(kernels.rdd_moment(*codes, kd, ka, z),
                       kernels.rdd_moment_plain(*codes, kd, ka, z))
    assert all(kernels.LAUNCHES[n] == launched[n] + (2 if n == "moment"
                                                     else 1)
               for n in kernels.NAMES)


def _walk_batch(H, R, k, seed, copies):
    """Rows at the walk's edges (csrc/walk.cuh: 4-row groups, columns
    32 apart on a warp's lanes, strips of 32 to 1024 rows): random and
    dense-hit repeat rows with m cycling over 0, 3 (inside the first
    group), 1023 (the last row of the first 1024-row strip) and 1025
    (inside the second one's first group); rows 1, 2 and 6 cut so that
    rlen - k falls inside a column group; last a pad row (rlen 1, m 0) as
    fused_batch appends.  Where H allows, each hap is shifted 1000 rows
    down behind random bases, so the read's hits cross rows 1023-1025
    and the strip boundary.  The rows but the pad row come `copies`
    times: more rows keep the tallest strips."""
    ms = (0, 3, 1023, 1025)
    parts = [random_rows(H, R, 5, seed, ms=ms),
             repeat_rows(H, R, 4, seed + 1, ms=ms)]
    haps, reads, rlens, m = (np.concatenate(x) for x in zip(*parts))
    if H > 2048:
        lead = np.frombuffer(b"ACGT", np.uint8)[
            np.random.default_rng(seed).integers(0, 4, (len(m), 1000))]
        haps = np.concatenate([lead, haps[:, :-1000]], 1)
    for b, off in ((1, 1), (2, 2), (6, 3)):
        rlens[b] -= (rlens[b] - k - off) % 4
        reads[b, rlens[b]:] = READ_PAD
    haps[-1], reads[-1], rlens[-1], m[-1] = HAP_PAD, READ_PAD, 1, 0
    return tuple(np.concatenate([x[:-1]] * copies + [x[-1:]])
                 for x in (haps, reads, rlens, m))


@pytest.mark.parametrize("H,R,copies", [(1000, 1300, 1), (4100, 770, 2),
                                        (4100, 4100, 3), (12544, 1024, 2)])
@pytest.mark.parametrize("k", [10, 20, 30, 40])
def test_walk_kernels_equal_plain_on_ragged_rows(cuda, H, R, copies, k):
    """The six kernels, on csrc/walk.cuh's on-chip walk, against their
    plain versions at ragged shapes and the walk's edges: hist, kept_hist
    and rdd_moment; left_hist with the 50-threshold d-table; moment with
    the m1b tables and with the 50-threshold tables and w10, as modes m1b
    and w10 call it; moment2 with both sets, as mode del calls it.  The
    fourth shape is a DEL-mode hap taller than its reads."""
    batch = _walk_batch(H, R, k, H + R + k, copies)
    h, r, rl, m, _ = batch_from_numpy(*batch, k // 10 - 1, cuda)
    codes = (*row_codes(h, r, rl, k), m, rl, k)
    want = kernels.hist_plain(*codes)
    for g, w in zip(kernels.hist(*codes), want):
        assert torch.equal(g, w)
    assert int(want[2][:, :2].sum()) > 0
    kd, ka = (kept_table(x, 10, 10, False, H, R) for x in want[:2])
    h_kept = kernels.kept_hist_plain(*codes, kd, ka)
    assert torch.equal(kernels.kept_hist(*codes, kd, ka), h_kept)
    assert int(h_kept.sum()) > 0
    found, z = intercept_z(h_kept, H, R)
    z = torch.where(found, z + 2 * m, 0).to(torch.int32)
    assert torch.equal(kernels.rdd_moment(*codes, kd, ka, z),
                       kernels.rdd_moment_plain(*codes, kd, ka, z))
    kd50 = kept_table(want[0], 10, 50, True, H, R)
    h_left = kernels.left_hist_plain(*codes, kd50)
    assert torch.equal(kernels.left_hist(*codes, kd50), h_left)
    assert int(h_left.sum()) > 0
    ka50 = kept_table(h_left, 10, 50, True, H, R)
    for keep, w10 in (((kd, ka), False), ((kd50, ka50), True)):
        mom = kernels.moment_plain(*codes, *keep, w10)
        assert torch.equal(kernels.moment(*codes, *keep, w10), mom)
        assert int(mom[:, 0].sum()) > 0
    mom2 = kernels.moment2_plain(*codes, kd, ka, kd50, ka50)
    assert torch.equal(kernels.moment2(*codes, kd, ka, kd50, ka50), mom2)
    assert int(mom2[:, 0].sum()) > 0 and int(mom2[:, 3].sum()) > 0


def _keep_batch(H, R, B, seed):
    """random_rows with m cycling over 31, 0 and 140, the first row's hap
    at length H (no HAP_PAD); where B > 1, last a pad row (rlen 1, m 0)
    as fused_batch appends."""
    haps, reads, rlens, ms = random_rows(H, R, B, seed, ms=(31, 0, 140))
    tail = haps[0] == HAP_PAD
    haps[0, tail] = np.frombuffer(b"ACGT", np.uint8)[
        np.random.default_rng(seed).integers(0, 4, int(tail.sum()))]
    if B > 1:
        rlens[-1], ms[-1] = 1, 0
        reads[-1] = READ_PAD
    return haps, reads, rlens, ms


@pytest.mark.parametrize("B,H,R,strip", [(1, 512, 512, 32),
                                         (20, 8192, 8192, 1024),
                                         (20, 12544, 1024, 384)])
@pytest.mark.parametrize("k", [10, 20, 30, 40])
def test_keep_kernels_on_chip_walk_equal_plain(cuda, B, H, R, strip, k):
    """The four keep-table kernels on the on-chip walk against their
    plain versions, bitwise: kept_hist and moment (want_w10 both ways)
    with the m1b tables, the 50-threshold tables, all-set and all-clear
    tables and each table set alone; left_hist with each of those
    d-tables; moment2 with the m1b pair beside the 50-threshold pair,
    both ways round, each of the six pairs on both sets, and the mixed
    pairs (one set all set, the other all clear, both ways).  B=1 small
    rows, where the grid plan picks 32-row strips; B=20 large rows, where
    it picks 1024-row ones; B=20 DEL rows (a 12544 hap, reads of 1024),
    where it picks 384-row strips at k = 10 and at every k a grid of one
    wave (checked through build.grid_info); m > 0 on most rows, a hap at
    length H."""
    from vapor_tpu_torch.engine.kernels import build
    for name in ("left_hist", "kept_hist", "moment", "moment2"):
        blocks, per_sm, sms, got, _ = build.grid_info(name, B, H, R,
                                                      k // 10 + 1)
        if k == 10 or strip != 384:
            assert got == strip, name
        assert blocks <= per_sm * sms or got == 1024, name
    haps, reads, rlens, ms = _keep_batch(H, R, B, H + R + k)
    h, r, rl, m, _ = batch_from_numpy(haps, reads, rlens, ms, k // 10 - 1,
                                      cuda)
    codes = (*row_codes(h, r, rl, k), m, rl, k)
    h_d, h_a, scal = kernels.hist_plain(*codes)
    assert int(scal[:, :2].sum()) > 0
    kd, ka = (kept_table(x, 10, 10, False, H, R) for x in (h_d, h_a))
    kd50 = kept_table(h_d, 10, 50, True, H, R)
    ka50 = kept_table(kernels.left_hist_plain(*codes, kd50), 10, 50, True,
                      H, R)
    ones, zeros = torch.ones_like(kd), torch.zeros_like(kd)
    tables = [(kd, ka), (kd50, ka50), (ones, ones), (zeros, zeros),
              (ones, zeros), (zeros, ones)]
    pairs = [(kd, ka, kd50, ka50), (kd50, ka50, kd, ka),
             *((*keep, *keep) for keep in tables),
             (ones, ones, zeros, zeros), (zeros, zeros, ones, ones)]
    launched = dict(kernels.LAUNCHES)
    for keep in tables:
        want = kernels.kept_hist_plain(*codes, *keep)
        assert torch.equal(kernels.kept_hist(*codes, *keep), want)
        for w10 in (False, True):
            want = kernels.moment_plain(*codes, *keep, w10)
            assert torch.equal(kernels.moment(*codes, *keep, w10), want)
    for keep_d in (kd, kd50, ones, zeros):
        want = kernels.left_hist_plain(*codes, keep_d)
        assert torch.equal(kernels.left_hist(*codes, keep_d), want)
    for pair in pairs:
        want = kernels.moment2_plain(*codes, *pair)
        assert torch.equal(kernels.moment2(*codes, *pair), want)
    assert kernels.LAUNCHES["kept_hist"] == launched["kept_hist"] + 6
    assert kernels.LAUNCHES["moment"] == launched["moment"] + 12
    assert kernels.LAUNCHES["left_hist"] == launched["left_hist"] + 4
    assert kernels.LAUNCHES["moment2"] == launched["moment2"] + 10
    # all-set tables keep every hit: kept_hist is hist's h_d, moment's
    # count every hit's multiplicity, left_hist drops none (and all-clear
    # d-tables keep none, so left_hist is hist's h_a); moment2's sets are
    # moment's, slot 2 stays 0
    assert torch.equal(kernels.kept_hist(*codes, ones, ones), h_d)
    every = kernels.moment(*codes, ones, ones, True)
    assert torch.equal(every[:, 0], h_d.long().sum(1))
    assert int(kernels.moment(*codes, zeros, zeros, True).abs().sum()) == 0
    assert int(kernels.left_hist(*codes, ones).abs().sum()) == 0
    assert torch.equal(kernels.left_hist(*codes, zeros), h_a)
    mixed = kernels.moment2(*codes, ones, ones, zeros, zeros)
    assert torch.equal(mixed[:, :2], every[:, :2])
    assert int(mixed[:, 2:].abs().sum()) == 0
    mixed = kernels.moment2(*codes, zeros, zeros, ones, ones)
    assert torch.equal(mixed[:, 3:], every)
    assert int(mixed[:, :3].abs().sum()) == 0


@pytest.mark.parametrize("H,R,copies", [(1000, 1300, 1), (4100, 770, 2),
                                        (12544, 1024, 2)])
@pytest.mark.parametrize("k", [10, 40])
def test_glue_kernels_equal_plain_on_ragged_rows(cuda, H, R, copies, k):
    """The three glue kernels against their plain versions, bitwise, on
    _walk_batch's ragged rows (a pad row last): row_codes with and
    without hap_index (every column), kept_tables with fused_rows' del
    tables in one launch (kd, ka, kd50), then ka50, and intercept_z on
    the kept d-histogram and on hist's h_d."""
    batch = _walk_batch(H, R, k, H + R + k, copies)
    h, r, rl, m, _ = batch_from_numpy(*batch, k // 10 - 1, cuda)
    launched = dict(kernels.LAUNCHES)
    plain_calls = dict(kernels.PLAIN_CUDA_CALLS)
    got = kernels.row_codes(h, r, rl, k)
    for g, w in zip(got, kernels.row_codes_plain(h, r, rl, k)):
        assert torch.equal(g, w)
    index = torch.arange(r.shape[0], device=cuda) % 3
    for g, w in zip(kernels.row_codes(h[:3].contiguous(), r, rl, k, index),
                    kernels.row_codes_plain(h[:3].contiguous(), r, rl, k,
                                            index)):
        assert torch.equal(g, w)
    codes = (*got, m, rl, k)
    h_d, h_a, _ = kernels.hist_plain(*codes)
    specs = ((10, False), (10, False), (50, True))
    tables = kernels.kept_tables((h_d, h_a, h_d), specs, H, R)
    for g, w in zip(tables, kernels.kept_tables_plain((h_d, h_a, h_d),
                                                      specs, H, R)):
        assert torch.equal(g, w)
    kd, ka, kd50 = tables
    h_left = kernels.left_hist_plain(*codes, kd50)
    ka50, = kernels.kept_tables((h_left,), ((50, True),), H, R)
    assert torch.equal(ka50, kernels.kept_tables_plain((h_left,),
                                                       ((50, True),), H,
                                                       R)[0])
    h_kept = kernels.kept_hist_plain(*codes, kd, ka)
    for x in (h_kept, h_d):
        for g, w in zip(kernels.intercept_z(x, H, R),
                        kernels.intercept_z_plain(x, H, R)):
            assert torch.equal(g, w)
    assert {n: kernels.LAUNCHES[n] - launched[n]
            for n in kernels.GLUE_NAMES} == {
        "row_codes": 2, "kept_tables": 2, "intercept_z": 2}
    assert {n: kernels.PLAIN_CUDA_CALLS[n] - plain_calls[n]
            for n in kernels.GLUE_NAMES} == {
        "row_codes": 2, "kept_tables": 2, "intercept_z": 2}


_OUT_OF_RANGE = textwrap.dedent("""
    import sys
    import torch
    from vapor_tpu_torch.engine import kernels
    bad = sys.argv[1]
    dev = torch.device("cuda")
    haps = torch.full((2, 128), 65, dtype=torch.uint8, device=dev)
    reads = torch.full((3, 96), 67, dtype=torch.uint8, device=dev)
    rlens = torch.tensor([96, 97 if bad == "rlens" else 50, 0],
                         dtype=torch.int32, device=dev)
    index = torch.tensor([0, 2 if bad == "hap_index" else 1, 1],
                         device=dev)
    kernels.row_codes(haps, reads, rlens, 10, index)
    torch.cuda.synchronize()
""")


@pytest.mark.parametrize("bad", ["hap_index", "rlens"])
def test_row_codes_stops_on_out_of_range_rows(cuda, bad):
    """A hap index outside [0, U) or a read length outside [0, R] stops
    the codes kernel with a device-side assert, as the plain version's
    index_select and gather stop on the card, and no word is read outside
    its row (run in a child process: the assert ends its CUDA context)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run([sys.executable, "-c", _OUT_OF_RANGE, bad],
                         cwd=root, capture_output=True, text=True,
                         timeout=600)
    assert run.returncode != 0
    assert "device-side assert triggered" in run.stderr, run.stderr[-2000:]


@pytest.mark.parametrize("scorer", ["m1b", "w10", "del", "rdd"])
def test_fused_batch_card_equals_cpu(cuda, scorer):
    """fused_batch on the card (the glue kernels in place, no plain
    version on CUDA tensors) against the CPU's plain path."""
    haps, reads, rlens, ms = _batch(1024, 1536, 11, seed=5)
    launched = dict(kernels.LAUNCHES)
    plain_calls = dict(kernels.PLAIN_CUDA_CALLS)
    for k_idx in range(4):
        on_card = fused_batch(*batch_from_numpy(haps, reads, rlens, ms,
                                                k_idx, cuda),
                              H=1024, R=1536, scorer=scorer)
        on_cpu = fused_batch(*batch_from_numpy(haps, reads, rlens, ms,
                                               k_idx, "cpu"),
                             H=1024, R=1536, scorer=scorer)
        for g, w in zip(on_card, on_cpu):
            assert torch.equal(g.cpu(), w)
    # four launches of each, or more where the rows split over cards
    assert kernels.PLAIN_CUDA_CALLS == plain_calls
    assert kernels.LAUNCHES["row_codes"] >= launched["row_codes"] + 4
    assert kernels.LAUNCHES["kept_tables"] >= launched["kept_tables"] + 4
    assert (kernels.LAUNCHES["intercept_z"] > launched["intercept_z"]) == \
        (scorer == "rdd")


@pytest.mark.parametrize("hap_index", [False, True])
@pytest.mark.parametrize("scorer", ["m1b", "w10", "del", "rdd"])
def test_row_split_on_two_streams_is_bitwise(cuda, scorer, hap_index):
    """maybe_mesh_rows over [cuda, cuda]: two parts, each on its own
    stream of the one card, give the one-device launch's packed rows bit
    for bit (and the CPU's); every kernel of the mode launches once per
    part."""
    haps, reads, rlens, ms = _batch(1536, 1024, 20, seed=9)
    h, r, rl, m, k_idx = batch_from_numpy(haps, reads, rlens, ms, 1, cuda)
    idx = None
    if hap_index:     # rows 0, 7, 14 share hap 0, and so on
        idx = torch.arange(20, device=cuda) % 7
        h = h[:7].contiguous()
    one = fused_batch_local(h, r, rl, m, k_idx, scorer, idx)[2]
    before = dict(kernels.LAUNCHES)
    got = maybe_mesh_rows(h, r, rl, m, k_idx, 1536, 1024, scorer,
                          hap_index=idx, devices=[cuda, cuda])
    launched = {n: kernels.LAUNCHES[n] - before[n] for n in kernels.NAMES}
    assert got is not None and torch.equal(got, one)
    cpu = fused_batch_local(*(x.cpu() for x in (h, r, rl, m)), k_idx,
                            scorer, None if idx is None else idx.cpu())[2]
    assert torch.equal(got.cpu(), cpu)
    assert launched["hist"] == 2
    assert all(n in (0, 2) for n in launched.values())


def _self_rows(H, B, seed):
    """(B, H) hap rows of mixed lengths up to H - 1 (one shorter than
    k = 40, one full) and their lengths: random bases, every third row
    with a tandem block of a 37 bp unit, every fourth in lower case."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGTacgt", np.uint8)
    haps = np.full((B, H), HAP_PAD, np.uint8)
    lengths = rng.integers(H // 3, H, B).astype(np.int32)
    lengths[0] = H - 1
    if B > 1:
        lengths[1] = 33
    for b in range(B):
        n = int(lengths[b])
        row = bases[rng.integers(0, 4, n) + 4 * (b % 4 == 3)]
        if b % 3 == 2 and n > 600:
            unit = row[:37]
            row[100:100 + 37 * 12] = np.tile(unit, 12)
        haps[b, :n] = row
    return haps, lengths


@pytest.mark.parametrize("H", [512, 4096, 16384])
@pytest.mark.parametrize("k", [10, 20, 30, 40])
def test_self_stats_route_equals_plain(cuda, H, k):
    """The window refiner's self-stats rows (the hap as its own read,
    m = 0, rlen = length, H = R) through the hist kernel's score route
    against its plain version, B = 1 and a full flush of the (H, window)
    group, and through its self-stats route (self_stats_rows) against
    that route's plain version and the same reduction of the plain
    histogram."""
    from vapor_tpu_torch.engine.batching import _row_cap
    from vapor_tpu_torch.engine.window_device import self_stats_rows
    for B in (1, _row_cap(H, H)):
        haps, lengths = _self_rows(H, B, seed=H + k + B)
        h = torch.from_numpy(haps).to(cuda)
        n = torch.from_numpy(lengths).to(cuda)
        reads = torch.where(torch.arange(H, device=cuda) < n[:, None].long(),
                            h, torch.full_like(h, READ_PAD))
        codes = (*row_codes(h, reads, n, k), torch.zeros_like(n), n, k)
        launched = kernels.LAUNCHES["hist"]
        routed = kernels.LAUNCH_SHAPES["hist", "selfstats", H, H]
        got = kernels.hist(*codes)
        want = kernels.hist_plain(*codes)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        rows = self_stats_rows(h, n, k)
        assert torch.equal(rows, kernels.hist_self_plain(*codes))
        assert kernels.LAUNCHES["hist"] == launched + 2
        assert kernels.LAUNCH_SHAPES["hist", "selfstats", H, H] == routed + 1
        w_d = want[0].long()
        assert torch.equal(rows, torch.stack(
            [w_d.sum(1), w_d[:, H], w_d[:, :H].sum(1)], 1))
        assert int(rows[0, 0]) > 0
        if B > 1:
            assert int(rows[1, 0]) == (0 if k >= 40 else int(rows[1, 1]))


def _events(seed, n):
    """n DEL-like events (ref, alt, reads) of 300-900 bp haps, 2-7 reads
    each with 8% substitutions and varied m."""
    rng = np.random.default_rng(seed)
    bases = np.array(list("ACGT"))
    out = []
    for _ in range(n):
        L = int(rng.choice([300, 400, 900]))
        ref = "".join(bases[rng.integers(0, 4, L)])
        alt = ref[:L // 3] + ref[2 * L // 3:]
        reads = []
        for i in range(int(rng.integers(2, 8))):
            donor = list(alt if rng.random() < 0.5 else ref)
            donor = donor[:int(rng.integers(len(donor) // 2, len(donor)))]
            for p in rng.integers(0, len(donor), len(donor) // 12):
                donor[p] = bases[rng.integers(0, 4)]
            reads.append(["".join(donor), int(rng.choice([0, 0, 13])),
                          f"r{i}"])
        out.append((ref, alt, reads))
    return out


def test_batching_on_card_equals_unbatched_under_concurrency(cuda):
    """BatchingBackend('cuda') against FusedBackend('cuda'), requests
    from 6 threads (scores and refiner self-stats rows), five rounds:
    a packed row read before its copy ended would differ somewhere."""
    from vapor_tpu_torch.engine.batching import BatchingBackend
    from vapor_tpu_torch.engine.fused import FusedBackend
    from vapor_tpu_torch.engine.window_device import self_stats_rows
    from concurrent.futures import ThreadPoolExecutor
    scorers = ["abs_dis_m1b", "within_10perc_m1b", "redefine_diagonal"]
    evs = _events(17, 24)
    base = FusedBackend("cuda")
    jobs = [(scorers[i % 3], ev, [10, 20][i % 2]) for i, ev in
            enumerate(evs)]
    want = [base.score_batch(s, *ev, w) for s, ev, w in jobs]
    want_del = [base.score_del_batch(*ev, 10) for ev in evs[:6]]
    hap_rows = [base._encode_hap(ev[0], 1024) for ev in evs]
    want_self = [self_stats_rows(torch.from_numpy(h[None]).to(cuda),
                                 torch.tensor([len(ev[0])], dtype=torch.int32,
                                              device=cuda), 20)[0].tolist()
                 for h, ev in zip(hap_rows, evs)]
    bat = BatchingBackend("cuda")
    for _ in range(5):
        with ThreadPoolExecutor(max_workers=6) as pool:
            got = list(pool.map(
                lambda j: bat.score_batch(j[0], *j[1], j[2]), jobs))
            got_del = list(pool.map(
                lambda ev: bat.score_del_batch(*ev, 10), evs[:6]))
            futs = [bat.submit_selfstats(h, len(ev[0]), 20, 1024)
                    for h, ev in zip(hap_rows, evs)]
            got_self = list(pool.map(
                lambda f: f.result(timeout=120).tolist(), futs))
        assert got == want
        assert got_del == want_del
        assert got_self == want_self


def test_band_census_on_card_equals_host_refiner(cuda):
    """Every fourth of the refiner-band census haps (sim/corpus.py
    repeat_cases, tandem arrays) through DeviceWindowRefiner on the card:
    its self-stats rows launch hist, some haps reach the band QC, and
    every window equals window_size_refine's."""
    from vapor_tpu_torch.engine.window import window_size_refine
    from vapor_tpu_torch.engine.window_device import (BAND_STATS,
                                                      DeviceWindowRefiner)
    from vapor_tpu_torch.sim.corpus import repeat_cases
    haps = [case[3] for case in repeat_cases()[::4]]
    refiner = DeviceWindowRefiner(region_qc_cff=0.4, seed=0, device="cuda")
    launched = kernels.LAUNCHES["hist"]
    hits = BAND_STATS["band_hits"]
    got = [refiner.refine(hap) for hap in haps]
    assert kernels.LAUNCHES["hist"] > launched
    assert BAND_STATS["band_hits"] > hits
    assert got == [window_size_refine(hap, 0.4, 0)[0] for hap in haps]


@pytest.mark.parametrize("backend", ["torch", "torch-nobatch"])
def test_goldens_on_card(cuda, backend):
    """The DEL, ins and svelter goldens through the CLI on the card
    (sim/goldens.py), byte-equal to fixtures/golden/, through the
    kernels of their modes (del, m1b, w10) and no plain version run on
    CUDA tensors."""
    from vapor_tpu_torch.sim.goldens import check_goldens
    got = check_goldens(backend, "cuda",
                        ["bed_del_11", "ins_melt", "svelter_basic"])
    assert all(r["ok"] for r in got.values()), got
    assert all(r["plain_on_cuda"] == 0 for r in got.values())
    assert all(r["launches"]["hist"] > 0 for r in got.values())
    assert got["bed_del_11"]["launches"]["moment2"] > 0
    assert got["ins_melt"]["launches"]["moment"] > 0
    assert got["svelter_basic"]["launches"]["left_hist"] > 0


@pytest.mark.parametrize("H,R", [(1536, 2560), (12544, 12544)])
def test_device_time_within_call_time(cuda, H, R):
    """timing.device_ms, a call's device work apart from host work (the
    C entry point's memset of the outputs and the kernel), is more than
    0 and at most the call's time with host work (call_ms), for each
    kernel route at a small and a large bucket, B=20.  Tolerance 5%:
    where the device work outlasts the host work both times are the same
    device work, and two windows of it differ by run-to-run noise."""
    haps, reads, rlens, ms = random_rows(H, R, 20, seed=H + R, ms=(0, 23))
    h, r, rl, m, _ = batch_from_numpy(haps, reads, rlens, ms, 0, cuda)
    codes = (*row_codes(h, r, rl, 10), m, rl, 10)
    h_d, h_a, _ = kernels.hist(*codes)
    kd, ka = (kept_table(x, 10, 10, False, H, R) for x in (h_d, h_a))
    kd50 = kept_table(h_d, 10, 50, True, H, R)
    ka50 = kept_table(kernels.left_hist(*codes, kd50), 10, 50, True, H, R)
    found, z = intercept_z(kernels.kept_hist(*codes, kd, ka), H, R)
    z = torch.where(found, z + 2 * m, 0).to(torch.int32)
    rest = {"hist": (), "left_hist": (kd50,), "kept_hist": (kd, ka),
            "moment": (kd50, ka50, True), "moment2": (kd, ka, kd50, ka50),
            "rdd_moment": (kd, ka, z)}
    for (name, route), wrapper in kernels.ROUTES.items():
        args = (*codes, *rest[name])
        call = functools.partial(getattr(kernels, wrapper), *args)
        device = timing.device_ms([call, functools.partial(
            getattr(kernels, wrapper), *timing.rolled(args))])
        called = timing.call_ms(call, 5)
        assert 0 < device <= 1.05 * called, (wrapper, device, called)
        assert timing.host_us([call]) > 0
