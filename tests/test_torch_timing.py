"""The kernels' card-time harness on the CPU (vapor_tpu_torch/engine/
kernels/timing.py and roofline.lost_ms): the launch-weighted time over
the bound on a hand-made LAUNCH_SHAPES counter, self-stats key included;
the capture of each (name, route, H, R)'s first wrapper call during
fused_batch and the refiner's self-stats rows; the B-row batches cut
from a call's real rows, pad rows left out, which give each row's
statistics unchanged (exact); and the hap lengths read back from the
codes.  The timings themselves need the card (tests/test_torch_cuda.py,
chip_smoke.py)."""
from collections import Counter

import pytest
import torch

from vapor_tpu_torch.engine import fused, kernels, window_device
from vapor_tpu_torch.engine.constants import HAP_PAD
from vapor_tpu_torch.engine.kernels import roofline, timing
from torch_rows import random_rows

CPU = torch.device("cpu")


def test_lost_ms_weights_each_shape_by_its_launches():
    shapes = Counter({("hist", "score", 1536, 3072): 10,
                      ("hist", "score", 12544, 12544): 2,
                      ("hist", "selfstats", 2048, 2048): 7,
                      ("moment2", "score", 12544, 1024): 3})
    device = {("hist", "score", 1536, 3072): 0.05,
              ("hist", "score", 12544, 12544): 0.40,
              ("hist", "selfstats", 2048, 2048): 0.02,
              ("moment2", "score", 12544, 1024): 0.06,
              ("moment", "score", 512, 512): 1.0}       # never launched
    bound = {("hist", "score", 1536, 3072): 0.01,
             ("hist", "score", 12544, 12544): 0.25,
             ("hist", "selfstats", 2048, 2048): 0.005,
             ("moment2", "score", 12544, 1024): 0.02,
             ("moment", "score", 512, 512): 0.1}
    lost = roofline.lost_ms(shapes, device, bound)
    assert lost.keys() == {("hist", "score"), ("hist", "selfstats"),
                           ("moment2", "score")}
    assert lost["hist", "score"] == pytest.approx(10 * 0.04 + 2 * 0.15)
    assert lost["hist", "selfstats"] == pytest.approx(7 * 0.015)
    assert lost["moment2", "score"] == pytest.approx(3 * 0.04)
    assert roofline.lost_ms(Counter(), device, bound) == {}
    shapes[("left_hist", "score", 4096, 1024)] += 1     # launched, untimed
    with pytest.raises(KeyError):
        roofline.lost_ms(shapes, device, bound)


def _batch(H, R, B, seed):
    return fused.batch_from_numpy(*random_rows(H, R, B, seed,
                                               ms=(0, 23, 0, 140)), 0, CPU)


def test_capture_keeps_each_shapes_first_call_at_k10():
    """fused_batch in mode del at k = 20, then k = 10, and the refiner's
    self-stats rows: one record per (name, route, H, R), at k = 10 where
    a call had it, copies of the arguments, which replay through the
    route's wrapper (kernels.ROUTES; the glue kernels' under route
    "glue"); the wrappers are restored after the block."""
    wrappers = (*kernels.ROUTES.values(), *kernels.GLUE_NAMES)
    real = {n: getattr(kernels, n) for n in wrappers}
    haps, reads, rlens, ms, _ = _batch(256, 192, 10, seed=3)
    lengths = torch.tensor([200, 180, 190], dtype=torch.int32)
    store = {}
    with timing.capture(store):
        for k_idx in (1, 0):
            fused.fused_batch(haps, reads, rlens, ms, k_idx, 256, 192, "del")
        selfstats = window_device.self_stats_rows(haps[:3], lengths, 20)
    assert {n: getattr(kernels, n) for n in wrappers} == real
    glue = {key: held for key, held in store.items() if key[1] == "glue"}
    assert set(glue) == {("row_codes", "glue", 256, 192),
                         ("kept_tables", "glue", 256, 192),
                         ("row_codes", "glue", 256, 256)}
    assert glue["row_codes", "glue", 256, 192][0][3] == 10
    assert glue["row_codes", "glue", 256, 256][0][3] == 20
    args, kwargs = glue["kept_tables", "glue", 256, 192]
    assert args[2:] == (256, 192) and kwargs == {}
    store = {key: held for key, held in store.items() if key[1] != "glue"}
    assert set(store) == {("hist", "score", 256, 192),
                          ("left_hist", "score", 256, 192),
                          ("moment2", "score", 256, 192),
                          ("hist", "selfstats", 256, 256)}
    for (name, route, H, R), (args, kwargs) in store.items():
        assert args[5] == (20 if route == "selfstats" else 10)
        assert kwargs == {}
        assert args[0].shape[2] == H and args[1].shape[2] == R
    args, kwargs = store["hist", "selfstats", 256, 256]
    replay = getattr(kernels, kernels.ROUTES["hist", "selfstats"])
    assert torch.equal(replay(*args, **kwargs), selfstats)
    args = store["hist", "score", 256, 192][0]
    assert args[0].shape[0] == 16          # 10 rows + 6 pad rows
    assert not any(a is b for a, b in zip(args, fused.row_codes(
        haps, reads, rlens, 10)))


def test_tile_rows_cycles_the_real_rows():
    """B rows that cycle through a call's real rows (fused_batch's pad
    rows, rlen 1, left out) give each row's statistics unchanged, and
    the rolled second batch the same rows in another order."""
    haps, reads, rlens, ms, _ = _batch(256, 192, 10, seed=4)
    store = {}
    with timing.capture(store):
        fused.fused_batch(haps, reads, rlens, ms, 0, 256, 192, "m1b")
    args, kwargs = store["moment", "score", 256, 192]
    assert kwargs == {"want_w10": False}
    assert int((args[4] == 1).sum()) == 6
    tiled = timing.tile_rows(args, 20)
    assert all(t.shape[0] == 20 and t.is_contiguous()
               for t in tiled if isinstance(t, torch.Tensor))
    assert torch.equal(tiled[4], rlens[torch.arange(20) % 10])
    assert tiled[5] == 10
    want = kernels.moment_plain(*args, **kwargs)[:10]
    assert torch.equal(kernels.moment_plain(*tiled, **kwargs),
                       want[torch.arange(20) % 10])
    second = timing.rolled(tiled)
    assert torch.equal(kernels.moment_plain(*second, **kwargs),
                       want[(torch.arange(20) - 1) % 10])
    one = timing.tile_rows(args, 1)
    assert one[0].shape[0] == 1 and torch.equal(one[4], rlens[:1])


@pytest.mark.parametrize("k", [10, 20, 30, 40])
def test_hap_lens_from_codes(k):
    haps, reads, rlens, _ = random_rows(320, 256, 6, seed=k)
    ch = kernels.pack_codes(torch.from_numpy(haps), k, HAP_PAD)
    want = [int(n) for n in (haps != HAP_PAD).sum(1)]
    assert timing.hap_lens(ch, k) == want
    assert len(set(want)) > 1


def test_device_timings_need_wrapper_calls_on_the_card():
    """A call that launches nothing (a wrapper on CPU tensors runs its
    plain version) has no launch to time, and one batch is refused."""
    codes = (*fused.row_codes(*_batch(128, 128, 2, seed=5)[:3], 10),
             torch.zeros(2, dtype=torch.int32),
             torch.full((2,), 100, dtype=torch.int32), 10)
    with pytest.raises(ValueError, match="two input batches"):
        timing.device_ms([lambda: kernels.hist(*codes)])
    with pytest.raises(RuntimeError, match="want one launch"):
        timing._Launch(lambda: kernels.hist(*codes))
