"""vapor_tpu_torch's CUDA kernels against their plain PyTorch versions,
and the fused engine on the card against the same engine on the CPU.

Needs a CUDA card and nvcc: each test skips without one.  Run on the
card with  python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from vapor_tpu_torch.engine import kernels
from vapor_tpu_torch.engine.constants import READ_PAD
from vapor_tpu_torch.engine.fused import (batch_from_numpy, fused_batch,
                                          kept_table, row_codes)
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
    assert all(kernels.LAUNCHES[n] == launched[n] + (2 if n == "moment"
                                                     else 1)
               for n in kernels.NAMES)


@pytest.mark.parametrize("scorer", ["m1b", "w10", "del"])
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
