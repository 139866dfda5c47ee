"""vapor_tpu_torch's device window refiner on the CPU against vapor_tpu:
the self-stats rows through ``kernels.hist_self`` (hist's self-stats
route, plain version) equal the JAX ``_self_stats`` and
``_self_stats_rows_packed`` exactly, and the refiner's windows equal
``window_size_refine`` and vapor_tpu's ``DeviceWindowRefiner``."""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vapor_tpu.engine import oracle as joracle
from vapor_tpu.engine.fused import pack_nibbles
from vapor_tpu.engine.window import window_size_refine
from vapor_tpu.engine.window_device import DeviceWindowRefiner as JaxRefiner
from vapor_tpu.engine.window_device import (_RC_PAD, _self_stats,
                                            _self_stats_rows_packed)
from vapor_tpu_torch.engine import kernels
from vapor_tpu_torch.engine.constants import HAP_PAD, READ_PAD, bucket_for
from vapor_tpu_torch.engine.fused import row_codes
from vapor_tpu_torch.engine.window_device import (BAND_STATS,
                                                  DeviceWindowRefiner,
                                                  self_stats_rows)
from test_window_device import cases

torch.set_num_threads(1)      # the suite runs several processes at once


def _rand(rng, n):
    return "".join(rng.choice("ACGT") for _ in range(n))


def _seqs():
    """Random, a 40 bp unit x8 tandem block, lower case with 20 N, a hap
    shorter than k = 30 and 40, and a length that pads 513 -> 768."""
    rng = random.Random(11)
    return [_rand(rng, 700), _rand(rng, 40) * 8 + _rand(rng, 60),
            _rand(rng, 100).lower() + "N" * 20 + _rand(rng, 80),
            _rand(rng, 25), _rand(rng, 513)]


def _hap(seq, H):
    codes = joracle.encode(seq)
    hap = np.full(H, HAP_PAD, np.uint8)
    hap[:len(codes)] = codes
    return hap


@pytest.mark.parametrize("k", [10, 20, 30, 40])
def test_self_stats_rows_match_jax(k):
    """One hap per call against _self_stats, exactly."""
    nonzero = 0
    for seq in _seqs():
        H = bucket_for(len(seq) + 1)
        hap = _hap(seq, H)
        rc = np.full(H, _RC_PAD, np.uint8)
        rc[:len(seq)] = joracle.encode_comp(seq)[::-1]
        want = np.asarray(_self_stats(jnp.asarray(hap), jnp.asarray(rc),
                                      jnp.int32(len(seq)),
                                      jnp.int32(k // 10 - 1), H=H))
        got = self_stats_rows(torch.from_numpy(hap[None]),
                              torch.tensor([len(seq)], dtype=torch.int32),
                              k)
        assert got.dtype == torch.int64 and got.shape == (1, 3)
        assert got[0].tolist() == want.tolist(), (len(seq), k)
        nonzero += int(want[0]) > 0
    assert nonzero >= 4 - (k >= 30)     # the 25 bp hap is empty there


def _hap_rows(case: str, H: int):
    """The sequences, their (B, H) hap rows and their lengths, from a
    numpy seed: "mixed" lengths from 30 to H - 1, a "tandem" 2-bp repeat
    (every other diagonal hits), and a hap that "fills" its bucket
    (length H)."""
    rng = np.random.default_rng(len(case) + H)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    if case == "mixed":
        lengths = [H - 1, 30, H // 2 + 7, 3 * H // 4, 101]
        seqs = [acgt[rng.integers(0, 4, n)] for n in lengths]
    elif case == "tandem":
        seqs = [np.resize(np.frombuffer(b"AC", np.uint8), H - 9),
                np.concatenate([acgt[rng.integers(0, 4, 60)],
                                np.resize(np.frombuffer(b"GT", np.uint8),
                                          H // 2)])]
    else:
        seqs = [acgt[rng.integers(0, 4, H)]]
    seqs = [bytes(x).decode() for x in seqs]
    return (seqs, np.stack([_hap(x, H) for x in seqs]),
            np.array([len(x) for x in seqs], np.int32))


@pytest.mark.parametrize("case", ["mixed", "tandem", "full"])
@pytest.mark.parametrize("k", [10, 20, 30, 40])
def test_self_stats_plain_matches_jax(case, k):
    """hist's self-stats route, plain version (kernels.hist_self on CPU
    tensors: [total, diag, below] summed from each row's hits), against
    the JAX _self_stats of each hap and _self_stats_rows_packed of the
    batch, exactly; and against the score route's h_d reduced the way
    the refiner read it before the route had an entry point of its
    own."""
    H = 512
    seqs, haps, lengths = _hap_rows(case, H)
    h, n = torch.from_numpy(haps), torch.from_numpy(lengths)
    reads = torch.where(torch.arange(H) < n[:, None].long(), h,
                        torch.full_like(h, READ_PAD))
    codes = (*row_codes(h, reads, n, k), torch.zeros_like(n), n, k)
    got = kernels.hist_self(*codes)
    assert torch.equal(got, self_stats_rows(h, n, k))
    want = np.asarray(_self_stats_rows_packed(
        jnp.asarray(pack_nibbles(haps)), jnp.asarray(lengths),
        jnp.int32(k // 10 - 1), H=H))
    assert got.tolist() == want.tolist()
    for b, seq in enumerate(seqs):
        rc = np.full(H, _RC_PAD, np.uint8)
        rc[:len(seq)] = joracle.encode_comp(seq)[::-1]
        one = np.asarray(_self_stats(jnp.asarray(haps[b]), jnp.asarray(rc),
                                     jnp.int32(len(seq)),
                                     jnp.int32(k // 10 - 1), H=H))
        assert got[b].tolist() == one.tolist(), (case, k, b)
    h_d = kernels.hist_plain(*codes)[0].long()
    assert torch.equal(got, torch.stack(
        [h_d.sum(1), h_d[:, H], h_d[:, :H].sum(1)], 1))
    assert (got[:, 1].numpy() >= (lengths - k + 1).clip(0)).all()  # diagonal
    if case == "tandem":
        assert (got[:, 2] > got[:, 1]).all()     # repeats fill "below"


@pytest.mark.parametrize("k", [10, 40])
def test_self_stats_rows_batch_of_mixed_lengths(k):
    """Several lengths in one (B, H) batch, as one batching flush of an
    (H, window) group holds them, against _self_stats_rows_packed."""
    rng = random.Random(k)
    body = _rand(rng, 150)
    seqs = [_rand(rng, 1000), _rand(rng, 513), body * 4 + _rand(rng, 100),
            _rand(rng, 36), _rand(rng, 777).lower(), _rand(rng, 1023)]
    H = 1024
    haps = np.stack([_hap(s, H) for s in seqs])
    lengths = np.array([len(s) for s in seqs], np.int32)
    want = np.asarray(_self_stats_rows_packed(
        jnp.asarray(pack_nibbles(haps)), jnp.asarray(lengths),
        jnp.int32(k // 10 - 1), H=H))
    got = self_stats_rows(torch.from_numpy(haps), torch.from_numpy(lengths),
                          k)
    assert got.tolist() == want.tolist()
    assert (want[:, 2] > 0).any()       # the tandem block fills "below"


def test_refiner_matches_host_and_jax():
    """test_window_device.py's cases (the same seed): the port's refiner
    on the CPU equals window_size_refine and vapor_tpu's refiner."""
    ours, theirs = DeviceWindowRefiner(device="cpu"), JaxRefiner()
    for seq in cases():
        host_w, _ = window_size_refine(seq)
        assert ours.refine(seq) == host_w == theirs.refine(seq), len(seq)


def test_band_qc_leg_matches_host():
    """test_window_device.py's tandem-array fixtures (the same seed)
    reach the (0.1, 0.5) band and its worker-pool QC."""
    rng = random.Random(5)

    def rep_hap(span, period, frac):
        unit = _rand(rng, period)
        n = max(2, int(span * frac / period))
        body = "".join(
            "".join(rng.choice("ACGT") if rng.random() < 0.05 else c
                    for c in unit) for _ in range(n))
        rest = span - len(body)
        return (_rand(rng, 500 + rest // 2) + body +
                _rand(rng, 500 + rest - rest // 2))

    refiner = DeviceWindowRefiner(region_qc_cff=0.4, seed=0, device="cpu")
    before = BAND_STATS["band_hits"]
    for period, frac in ((15, 0.8), (40, 0.8), (40, 0.4)):
        seq = rep_hap(1200, period, frac)
        assert refiner.refine(seq) == window_size_refine(seq, 0.4, 0)[0]
    assert BAND_STATS["band_hits"] > before


def test_x_and_n_guards():
    """X is stripped before anything else; more than 100 N/n gives None
    without a device round trip."""
    rng = random.Random(2)
    base = _rand(rng, 600)
    refiner = DeviceWindowRefiner(device="cpu")
    calls = BAND_STATS["refine_calls"]
    assert refiner.refine(base[:300] + "N" * 60 + "n" * 41 + base) is None
    assert BAND_STATS["refine_calls"] == calls
    with_x = base[:200] + "X" * 700 + base[200:]
    assert refiner.refine(with_x) == window_size_refine(with_x)[0] == \
        refiner.refine(base)
    assert refiner.refine("X" * 50 + base[:5]) is None   # shorter than k


def test_unbucketable_hap_takes_host_refiner():
    rng = random.Random(4)
    seq = _rand(rng, 16400)
    refiner = DeviceWindowRefiner(device="cpu")
    before = BAND_STATS["unbucketable_host_refines"]
    assert refiner.refine(seq) == window_size_refine(seq)[0]
    assert BAND_STATS["unbucketable_host_refines"] == before + 1


def test_out_of_alphabet_hap_takes_host_refiner():
    """A byte outside the engine alphabet would match every other such
    byte in packed codes: the exact host refiner takes the hap."""
    rng = random.Random(6)
    body = _rand(rng, 120)
    seq = _rand(rng, 300) + body + "é" + body + _rand(rng, 300)
    refiner = DeviceWindowRefiner(device="cpu")
    before = BAND_STATS["vocab_host_refines"]
    assert refiner.refine(seq) == window_size_refine(seq)[0]
    assert BAND_STATS["vocab_host_refines"] == before + 1
