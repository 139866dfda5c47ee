"""vapor_tpu_torch's CUDA kernels against their plain PyTorch versions,
and the fused engine on the card against the same engine on the CPU.

Needs a CUDA card and nvcc: each test skips without one.  Run on the
card with  python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from vapor_tpu_torch.engine import kernels
from vapor_tpu_torch.engine.constants import HAP_PAD, READ_PAD
from vapor_tpu_torch.engine.fused import (batch_from_numpy, fused_batch,
                                          intercept_z, kept_table,
                                          row_codes)
from vapor_tpu_torch.sim.scale import repeat_rows
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
    kd, ka = (kept_table(x, 10, 10, False) for x in want[:2])
    kd50 = kept_table(want[0], 10, 50, True)
    left = kernels.left_hist(*codes, kd50)
    assert torch.equal(left, kernels.left_hist_plain(*codes, kd50))
    ka50 = kept_table(left, 10, 50, True)
    for keep, w10 in (((kd, ka), False), ((kd50, ka50), True)):
        assert torch.equal(kernels.moment(*codes, *keep, w10),
                           kernels.moment_plain(*codes, *keep, w10))
    assert torch.equal(kernels.moment2(*codes, kd, ka, kd50, ka50),
                       kernels.moment2_plain(*codes, kd, ka, kd50, ka50))
    h_kept = kernels.kept_hist(*codes, kd, ka)
    assert torch.equal(h_kept, kernels.kept_hist_plain(*codes, kd, ka))
    found, z = intercept_z(h_kept, H)
    z = torch.where(found, z + 2 * m, 0).to(torch.int32)
    assert torch.equal(kernels.rdd_moment(*codes, kd, ka, z),
                       kernels.rdd_moment_plain(*codes, kd, ka, z))
    assert all(kernels.LAUNCHES[n] == launched[n] + (2 if n == "moment"
                                                     else 1)
               for n in kernels.NAMES)


def _walk_batch(H, R, k, seed, copies):
    """Rows at the strip walk's edges (csrc/walk.cuh: 4-row groups,
    4-column thread groups, strips of 32 to 1024 rows): random and
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
    """The six kernels, all on the strip walk, against their plain
    versions at ragged shapes and the walk's edges: hist, kept_hist and
    rdd_moment; left_hist with the 50-threshold d-table; moment with the
    m1b tables and with the 50-threshold tables and w10, as modes m1b and
    w10 call it; moment2 with both sets, as mode del calls it.  On the
    H100's 132 SMs the first shape runs on 32-row strips, the second on
    128-row ones, the third on 1024-row ones and the fourth, a DEL-mode
    hap taller than its reads, on 256-row ones."""
    batch = _walk_batch(H, R, k, H + R + k, copies)
    h, r, rl, m, _ = batch_from_numpy(*batch, k // 10 - 1, cuda)
    codes = (*row_codes(h, r, rl, k), m, rl, k)
    want = kernels.hist_plain(*codes)
    for g, w in zip(kernels.hist(*codes), want):
        assert torch.equal(g, w)
    assert int(want[2][:, :2].sum()) > 0
    kd, ka = (kept_table(x, 10, 10, False) for x in want[:2])
    h_kept = kernels.kept_hist_plain(*codes, kd, ka)
    assert torch.equal(kernels.kept_hist(*codes, kd, ka), h_kept)
    assert int(h_kept.sum()) > 0
    found, z = intercept_z(h_kept, H)
    z = torch.where(found, z + 2 * m, 0).to(torch.int32)
    assert torch.equal(kernels.rdd_moment(*codes, kd, ka, z),
                       kernels.rdd_moment_plain(*codes, kd, ka, z))
    kd50 = kept_table(want[0], 10, 50, True)
    h_left = kernels.left_hist_plain(*codes, kd50)
    assert torch.equal(kernels.left_hist(*codes, kd50), h_left)
    assert int(h_left.sum()) > 0
    ka50 = kept_table(h_left, 10, 50, True)
    for keep, w10 in (((kd, ka), False), ((kd50, ka50), True)):
        mom = kernels.moment_plain(*codes, *keep, w10)
        assert torch.equal(kernels.moment(*codes, *keep, w10), mom)
        assert int(mom[:, 0].sum()) > 0
    mom2 = kernels.moment2_plain(*codes, kd, ka, kd50, ka50)
    assert torch.equal(kernels.moment2(*codes, kd, ka, kd50, ka50), mom2)
    assert int(mom2[:, 0].sum()) > 0 and int(mom2[:, 3].sum()) > 0


@pytest.mark.parametrize("scorer", ["m1b", "w10", "del", "rdd"])
def test_fused_batch_card_equals_cpu(cuda, scorer):
    haps, reads, rlens, ms = _batch(1024, 1536, 11, seed=5)
    for k_idx in range(4):
        on_card = fused_batch(*batch_from_numpy(haps, reads, rlens, ms,
                                                k_idx, cuda),
                              H=1024, R=1536, scorer=scorer)
        on_cpu = fused_batch(*batch_from_numpy(haps, reads, rlens, ms,
                                               k_idx, "cpu"),
                             H=1024, R=1536, scorer=scorer)
        for g, w in zip(on_card, on_cpu):
            assert torch.equal(g.cpu(), w)
