"""vapor_tpu_torch's fused engine (plain PyTorch, CPU) against the JAX
engine, exactly: every statistic is an integer.

One numpy batch is built from a seed (or from the scenario sets of
test_fused_vs_oracle / test_fused_del_mode) and handed to both
vapor_tpu.engine.fused._fused_batch_jit and the port.  The JAX engine is
called directly: fused_batch would route through the 8-device CPU mesh
this suite forces.  Each kernel's plain version is also held against
the JAX helpers that compute the same stage.
"""
import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vapor_tpu.engine import fused as jf
from vapor_tpu.engine.fused import FusedStats as JaxStats
from vapor_tpu_torch.engine import fused as tf
from vapor_tpu_torch.engine import kernels
from vapor_tpu_torch.engine.constants import HAP_PAD, READ_PAD, hist_width
from test_fused_vs_oracle import _mutate, _scenarios
from torch_rows import random_rows

# one small shape for every row (padding changes no statistic), so the
# JAX engine compiles once per scorer; one torch thread, as the suite
# runs several test processes at once
H = R = 768
torch.set_num_threads(1)


def _scenario_rows():
    """(hap, read, m) rows of the scenario sets, as the backends encode
    them: DEL, INV, no-SV, the odd-alphabet and the palindromic cases
    (the DUP haps need a larger bucket)."""
    rows = []
    for n, (ref_hap, alt_hap, reads, _) in enumerate(_scenarios()):
        if n in (4, 5):
            continue
        for i, r in enumerate(reads[:2]):
            rows.append((ref_hap.upper() if i % 2 else alt_hap, r[0], r[1]))
    rng = random.Random(77)
    for trial in range(4):
        flank = rng.choice([120, 200])
        body = "".join(rng.choice("ACGT") for _ in range(200))
        left = "".join(rng.choice("ACGT") for _ in range(flank))
        right = "".join(rng.choice("ACGT") for _ in range(flank))
        ref_hap = left + body + right
        if trial == 3:
            ref_hap = ref_hap[:50].lower() + ref_hap[50:]
        donor = left + right if trial % 2 else ref_hap
        rows.append((ref_hap, _mutate(donor, rng, 0.08),
                     rng.choice([0, 23])))
    be = tf.FusedBackend("cpu")
    haps = np.stack([be._encode_hap(h, H) for h, _, _ in rows])
    fw, rlens, ms = be._encode_reads([[r, m] for _, r, m in rows], R)
    return haps, fw, rlens, ms


def _batch():
    """The scenario rows plus random rows with m = 0 and m = 23, in a
    row count that is no multiple of 8 (fused_batch pads with rlen-1,
    m-0 rows and cuts them off)."""
    parts = [_scenario_rows(), random_rows(H, R, 4, seed=3),
             random_rows(H, R, 3, seed=4, ms=(23,))]
    batch = tuple(np.concatenate(x) for x in zip(*parts))
    assert batch[0].shape[0] % 8
    return batch


def _jax_batch(batch, k_idx, Hs, Rs, scorer):
    haps, reads, rlens, ms = batch
    h_d, h_a, packed = jf._fused_batch_jit(
        jnp.asarray(haps), jnp.asarray(reads), None, jnp.asarray(rlens),
        jnp.asarray(ms), jnp.int32(k_idx), H=Hs, R=Rs, scorer=scorer,
        want_hists=True)
    return (np.asarray(h_d), np.asarray(h_a),
            JaxStats(None, None, packed), np.asarray(packed, np.int64))


FIELDS = ("n_dots", "i_min", "i_max", "cnt", "sum_absd", "w10")


def _assert_same(batch, k_idx, Hs, Rs, scorer):
    j_d, j_a, js, j_packed = _jax_batch(batch, k_idx, Hs, Rs, scorer)
    t_d, t_a, packed = tf.fused_batch(
        *tf.batch_from_numpy(*batch, k_idx, "cpu"), H=Hs, R=Rs,
        scorer=scorer)
    ts = tf.FusedStats(t_d, t_a, packed)
    assert np.array_equal(t_d.numpy(), j_d)
    assert np.array_equal(t_a.numpy(), j_a)
    fields = FIELDS + (("cnt2", "w10_2") if scorer == "del" else ())
    for f in fields:
        assert np.array_equal(getattr(ts, f), getattr(js, f)), f
    if scorer == "del":   # within-10% sum |d|: JAX moment columns 16-17
        assert np.array_equal(ts.sum_absd2, (j_packed[:, 22] << 16) +
                              j_packed[:, 23])
    return ts


BATCH = _batch()


@pytest.mark.parametrize("scorer", ["m1b", "w10", "del"])
@pytest.mark.parametrize("k_idx", [0, 1, 2, 3])
def test_fused_batch_matches_jax(scorer, k_idx):
    ts = _assert_same(BATCH, k_idx, H, R, scorer)
    assert int(ts.n_dots.sum()) > 0 and int(ts.cnt.sum()) > 0
    if scorer != "m1b":
        assert int((ts.w10 if scorer == "w10" else ts.w10_2).sum()) > 0


# ---------------------------------------------------------------------------
# per-kernel plain versions against the JAX stages
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("Hs", "Rs"))
def _jax_stages(hap, read, rlen, m, k_idx, Hs, Rs):
    """One row's JAX stages: hits, both histograms, the scalars, the
    within-10% leftover histogram and both moment sets."""
    W = jf.hist_width(Hs, Rs)
    rc = jf._derive_rc_row(read, rlen)
    Kf = jf._hits_packed(hap, read, k_idx, m)
    Kr = jf._hits_packed_rc_dot(hap, rc, rlen, k_idx, m)
    Ksum = Kf.astype(jnp.int8) + Kr.astype(jnp.int8)
    h_d = jf.skew_reduce(Ksum, W, -1, Hs)
    h_a = jf.skew_reduce(Ksum, W, +1, 0)
    rows = jax.lax.broadcasted_iota(jnp.int32, (Hs, Rs), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (Hs, Rs), 1)
    ip = rows - m
    d = cols - ip
    kd = jf.kept_table_device(h_d, 10, 10, False)
    ka = jf.kept_table_device(h_a, 10, 10, False)
    keep = jf.unskew_broadcast(kd, Hs, -1, Hs, Rs) | \
        jf.unskew_broadcast(ka, Hs, +1, 0, Rs)
    kd50 = jf.kept_table_device(h_d, 10, 50, True)
    not_kept = ~jf.unskew_broadcast(kd50, Hs, -1, Hs, Rs)
    h_left = jf.skew_reduce(Ksum * not_kept.astype(jnp.int8), W, +1, 0)
    ka50 = jf.kept_table_device(h_left, 10, 50, True)
    keep50 = (~not_kept) | jf.unskew_broadcast(ka50, Hs, +1, 0, Rs)
    z = jnp.int32(0)
    mom = jf._moment_block(Ksum, keep, ip, d, z, False, False)
    mom50 = jf._moment_block(Ksum, keep50, ip, d, z, True, False)
    any_row = (Kf | Kr).sum(axis=1) > 0
    ridx = jnp.arange(Hs)
    scal = jnp.stack([Kf.sum(), Kr.sum(),
                      jnp.min(jnp.where(any_row, ridx, Hs + 1)),
                      jnp.max(jnp.where(any_row, ridx, -1))])
    return (h_d, h_a, scal, h_left, kd, ka, kd50, ka50, mom, mom50)


def _moments(mom):
    m = np.asarray(mom, np.int64)
    return [(m[0] << 16) + m[1], (m[2] << 16) + m[3], (m[4] << 16) + m[5]]


@pytest.mark.parametrize("k", [10, 20, 30, 40])
@pytest.mark.parametrize("m", [0, 23])
def test_kernel_plain_versions_match_jax_stages(k, m):
    Hs, Rs, B = 512, 512, 3
    # 2% error: 40-mers still hit, so every stage sees work at every k
    batch = random_rows(Hs, Rs, B, seed=k + m, ms=(m,), err=0.02)
    h, r, rl, ms, _ = tf.batch_from_numpy(*batch, k // 10 - 1, "cpu")
    codes = (*tf.row_codes(h, r, rl, k), ms, rl, k)
    h_d, h_a, scal = kernels.hist(*codes)
    kd, ka = (tf.kept_table(x, 10, 10, False) for x in (h_d, h_a))
    kd50 = tf.kept_table(h_d, 10, 50, True)
    h_left = kernels.left_hist(*codes, kd50)
    ka50 = tf.kept_table(h_left, 10, 50, True)
    mom = kernels.moment(*codes, kd, ka, False)
    mom50 = kernels.moment(*codes, kd50, ka50, True)
    mom2 = kernels.moment2(*codes, kd, ka, kd50, ka50)
    for b in range(B):
        want = _jax_stages(*(jnp.asarray(x[b]) for x in batch),
                           jnp.int32(k // 10 - 1), Hs=Hs, Rs=Rs)
        (j_d, j_a, j_scal, j_left, j_kd, j_ka, j_kd50, j_ka50, j_mom,
         j_mom50) = (np.asarray(x) for x in want)
        assert np.array_equal(h_d[b].numpy(), j_d)          # hist
        assert np.array_equal(h_a[b].numpy(), j_a)
        assert np.array_equal(scal[b].numpy(), j_scal)
        for got, table in ((kd, j_kd), (ka, j_ka), (kd50, j_kd50),
                           (ka50, j_ka50)):                 # kept_table
            assert np.array_equal(got[b].numpy(), table)
        assert np.array_equal(h_left[b].numpy(), j_left)    # left_hist
        assert mom[b].tolist() == [*_moments(j_mom)[:2], 0]  # moment
        assert mom50[b].tolist() == _moments(j_mom50)
        assert mom2[b].tolist() == [*_moments(j_mom)[:2], 0,  # moment2
                                    *_moments(j_mom50)]
    assert int(scal[:, :2].sum()) > 0 and int(h_left.sum()) > 0


# ---------------------------------------------------------------------------
# codes and tables
# ---------------------------------------------------------------------------

_jax_pack = jax.jit(jf._pack_codes, static_argnums=(1, 2))
_jax_rc_dot = jax.jit(jf._rc_dot_codes, static_argnums=(2,))


@pytest.mark.parametrize("k", [10, 20, 30, 40])
def test_codes_match_jax(k):
    haps, reads, rlens, _ = random_rows(256, 384, 4, seed=k)
    rlens[1] = k - 3                       # shorter than a k-mer
    h, r, rl, _, _ = tf.batch_from_numpy(haps, reads, rlens,
                                         np.zeros(4, np.int32), 0, "cpu")
    ch, cf, cd = tf.row_codes(h, r, rl, k)
    rc = tf.derive_rc_rows(r, rl)
    for b in range(4):
        j_rc = np.asarray(jf._derive_rc_row(jnp.asarray(reads[b]),
                                            jnp.int32(rlens[b])))
        assert np.array_equal(rc[b].numpy(), j_rc)
        for got, want in (
                (ch[b], _jax_pack(jnp.asarray(haps[b]), k, HAP_PAD)),
                (cf[b], _jax_pack(jnp.asarray(reads[b]), k, READ_PAD))):
            assert np.array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))
        want = np.asarray(_jax_rc_dot(jnp.asarray(j_rc),
                                      jnp.int32(rlens[b]), k))
        ok = np.arange(384) <= rlens[b] - k     # the eligible columns
        assert np.array_equal(cd[b].numpy().view(np.uint32)[:, ok],
                              want[:, ok])


@pytest.mark.parametrize("thr,fallback", [(10, False), (50, True),
                                          (10**6, True)])
def test_kept_table_matches_jax(thr, fallback):
    rng = np.random.default_rng(thr)
    h = np.zeros((6, 640), np.int32)
    for b in range(6):
        idx = rng.integers(0, 640, 60 + 20 * b)
        np.add.at(h[b], idx, rng.integers(1, 30, idx.size))
    h[5] = 0                               # an empty row
    got = tf.kept_table(torch.as_tensor(h), 10, thr, fallback).numpy()
    for b in range(6):
        want = np.asarray(jf.kept_table_device(jnp.asarray(h[b]), 10, thr,
                                               fallback))
        assert np.array_equal(got[b], want), b


def test_hist_width_matches_jax():
    for Hs in (512, 1536, 12544):
        for Rs in (512, 1024, 16384):
            assert hist_width(Hs, Rs) == jf.hist_width(Hs, Rs)


def test_wrappers_reject_bad_input_and_run_plain_on_cpu():
    batch = random_rows(256, 256, 2, seed=9)
    h, r, rl, ms, _ = tf.batch_from_numpy(*batch, 0, "cpu")
    ch, cf, cd = tf.row_codes(h, r, rl, 10)
    launched = dict(kernels.LAUNCHES)
    h_d, h_a, scal = kernels.hist(ch, cf, cd, ms, rl, 10)
    assert kernels.LAUNCHES == launched          # CPU: the plain version
    keep = tf.kept_table(h_d, 10, 10, False)
    bad = [
        ((ch, cf, cd, ms, rl, 20), "lanes"),                 # k vs lanes
        ((ch, cf, cd, ms, rl, 15), "k must be"),
        ((ch.long(), cf, cd, ms, rl, 10), "ch"),            # dtype
        ((ch, cf[:, :, :-1], cd, ms, rl, 10), "cf"),         # shape
        ((ch, cf, cd.transpose(1, 2).contiguous().transpose(1, 2), ms, rl,
          10), "contiguous"),
        ((ch, cf, cd, ms.long(), rl, 10), "ms"),
    ]
    for args, match in bad:
        with pytest.raises(ValueError, match=match):
            kernels.hist(*args)
    with pytest.raises(ValueError, match="table0"):
        kernels.left_hist(ch, cf, cd, ms, rl, 10, keep.int())
    with pytest.raises(ValueError, match="table1"):
        kernels.moment(ch, cf, cd, ms, rl, 10, keep, keep[:, :-1], False)
    with pytest.raises(NotImplementedError, match="rdd"):
        tf.fused_batch(h, r, rl, ms, 0, H=256, R=256, scorer="rdd")
