"""The refiner-band census haps (sim/corpus.py repeat_cases: tandem
arrays, where the window refiner's below-diagonal fraction lands in its
(0.1, 0.5) band and the host QC runs) through vapor_tpu_torch's
DeviceWindowRefiner on the CPU against vapor_tpu's: a dozen haps, every
ninth of the 108, give equal windows and equal band hits, and some hit
the band."""
import pytest
import torch

from vapor_tpu.engine import window_device as jwindow_device
from vapor_tpu_torch.engine import window_device
from vapor_tpu_torch.engine.window import window_size_refine
from vapor_tpu_torch.sim.corpus import repeat_cases

torch.set_num_threads(1)      # the suite runs several processes at once

HAPS = repeat_cases()[::9]


def _census(refiner, stats):
    windows, hits = [], []
    for _, _, _, hap in HAPS:
        before = stats["band_hits"]
        windows.append(refiner.refine(hap))
        hits.append(stats["band_hits"] - before)
    return windows, hits


@pytest.fixture(scope="module")
def jax_census():
    return _census(jwindow_device.DeviceWindowRefiner(region_qc_cff=0.4,
                                                      seed=0),
                   jwindow_device.BAND_STATS)


def test_band_census_equals_vapor_tpu(jax_census):
    got = _census(window_device.DeviceWindowRefiner(
        region_qc_cff=0.4, seed=0, device="cpu"), window_device.BAND_STATS)
    assert len(HAPS) == 12
    assert got == jax_census
    assert sum(got[1]) > 0 and sum(1 for h in got[1] if h) < len(HAPS)


def test_band_windows_equal_the_host_refiner(jax_census):
    """Both packages' device refiners give window_size_refine's window."""
    host = [window_size_refine(hap, 0.4, 0)[0] for _, _, _, hap in HAPS]
    assert jax_census[0] == host
    assert {10, 20} <= set(host)
