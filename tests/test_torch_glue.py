"""vapor_tpu_torch's glue kernels on the CPU: row_codes, kept_tables and
intercept_z (engine/kernels/__init__.py, csrc/codes.cu, kept_table.cu,
intercept.cu), exactly.

* Each wrapper on CPU tensors runs its plain version, which equals the
  JAX engine's function of the same stage on every element: _pack_codes,
  _derive_rc_batch and _rc_dot_codes (every column, the ones past
  rlen - k that no kernel reads included), kept_table_device and
  intercept_z_device, on seeded rows and on the edge rows the kernels
  must get right (rlen 0, rlen < k, rlen = R, fused_batch's pad rows;
  all-zero, one-bin and last-bin histograms, a fallback tie; found, tied
  and empty intercepts).
* A batched kept_tables call equals one call per table.
* Every argument check raises as it says.
* The card branch (kernels._plain patched): a call whose entry point
  fails raises and runs no plain version; the launch timing._Launch
  records has the C entry point's arguments; fused_rows and the
  refiner's self-stats rows launch the glue kernels and no torch-op
  version.
* csrc/codes.cu's symbol tables and pads are the Python ones.
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vapor_tpu.engine import fused as jf
from vapor_tpu_torch.engine import fused as tf
from vapor_tpu_torch.engine import kernels, oracle, window_device
from vapor_tpu_torch.engine.constants import (HAP_PAD, NIB_LUT, READ_PAD,
                                              hist_width)
from vapor_tpu_torch.engine.kernels import build, roofline, timing
from torch_rows import random_rows

torch.set_num_threads(1)

_jax_pack = jax.jit(jf._pack_codes, static_argnums=(1, 2))
_jax_rc_dot = jax.jit(jf._rc_dot_codes, static_argnums=(2,))
_jax_rc = jax.jit(jf._derive_rc_batch)
ALPHABET = np.frombuffer(b"ACGTNacgtnXx=", np.uint8)


def _edge_rows(H, R, B, seed):
    """Rows over the whole alphabet with rlen 0, rlen < 10, rlen = R and a
    pad row (HAP_PAD hap, READ_PAD read, rlen 1) first."""
    rng = np.random.default_rng(seed)
    haps = ALPHABET[rng.integers(0, ALPHABET.size, (B, H))]
    reads = ALPHABET[rng.integers(0, ALPHABET.size, (B, R))]
    rlens = rng.integers(20, R, B).astype(np.int32)
    rlens[:4] = [0, 7, R, 1]
    haps[3], reads[3] = HAP_PAD, READ_PAD
    haps[4, H - 50:] = HAP_PAD
    for b in range(B):
        reads[b, rlens[b]:] = READ_PAD
    return haps, reads, rlens


@pytest.mark.parametrize("k", [10, 20, 30, 40])
@pytest.mark.parametrize("rows", ["random", "edge"])
def test_row_codes_match_jax_on_every_column(k, rows):
    H, R, B = 256, 192, 6
    if rows == "random":
        haps, reads, rlens, _ = random_rows(H, R, B, seed=k)
        rlens[1] = k - 3                   # shorter than a k-mer
    else:
        haps, reads, rlens = _edge_rows(H, R, B, seed=k)
    ch, cf, cd = kernels.row_codes(*(torch.from_numpy(x) for x in
                                     (haps, reads, rlens)), k)
    rc = np.asarray(_jax_rc(jnp.asarray(reads), jnp.asarray(rlens)))
    for b in range(B):
        for got, want in (
                (ch[b], _jax_pack(jnp.asarray(haps[b]), k, HAP_PAD)),
                (cf[b], _jax_pack(jnp.asarray(reads[b]), k, READ_PAD)),
                (cd[b], _jax_rc_dot(jnp.asarray(rc[b]),
                                    jnp.int32(rlens[b]), k))):
            assert np.array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want)), b


def test_row_codes_hap_index_expands_the_hap_rows():
    haps, reads, rlens = (torch.from_numpy(x)
                          for x in _edge_rows(128, 160, 5, seed=2))
    index = torch.tensor([2, 0, 2, 1, 0])
    got = kernels.row_codes(haps[:3].contiguous(), reads, rlens, 20, index)
    want = kernels.row_codes(haps[[2, 0, 2, 1, 0]], reads, rlens, 20)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert got[0].shape == (5, 3, 128)


def _hist_rows(W, seed):
    """Histogram rows: random clusters, then the edge rows."""
    rng = np.random.default_rng(seed)
    h = np.zeros((10, W), np.int32)
    for b in range(5):
        idx = rng.integers(0, W, 30 + 25 * b)
        np.add.at(h[b], idx, rng.integers(1, 30, idx.size))
    # h[5] stays all zero
    h[6, W // 2] = 4                               # one bin
    h[7, [W - 40, W - 30, W - 21, W - 1]] = [3, 1, 2, 9]  # to the last bin
    h[8, [100, 109, 200, 210]] = 30                # gap - 1, then gap apart
    h[9, [50, 300]] = 20                           # a fallback tie
    return h


@pytest.mark.parametrize("thr,fallback", [(10, False), (50, True),
                                          (10 ** 6, True), (0, False)])
def test_kept_tables_match_jax(thr, fallback):
    h = _hist_rows(640, thr)
    got, = kernels.kept_tables((torch.from_numpy(h),), ((thr, fallback),),
                               256, 256)
    for b in range(h.shape[0]):
        want = np.asarray(jf.kept_table_device(jnp.asarray(h[b]), 10, thr,
                                               fallback))
        assert np.array_equal(got[b].numpy(), want), b
    assert not got[5].any()


def test_kept_tables_batch_equals_one_call_per_table():
    hs = [torch.from_numpy(_hist_rows(768, seed)) for seed in range(4)]
    specs = ((10, False), (50, True), (3, True), (10 ** 6, True))
    batched = kernels.kept_tables(tuple(hs), specs, 384, 256)
    assert len(batched) == 4
    for h, spec, got in zip(hs, specs, batched):
        one, = kernels.kept_tables((h,), (spec,), 384, 256)
        assert torch.equal(got, one)
        assert torch.equal(got, tf.kept_table(h, 10, *spec, 384, 256))


def _crafted(name):
    """(W, H, histogram) cases for the intercept fit's branches."""
    W, H = 640, 256
    h = np.zeros(W, np.int32)
    if name == "one_value":          # hi == lo: every value in bin 10
        h[300] = 7
    elif name == "one_bin":          # one first-level bin wins outright
        h[[100, 420]] = 1
        h[250:256] = [3, 1, 4, 1, 5, 9]
    elif name == "sub_hi_eq_lo":     # the winning bin holds one value
        h[[100, 300, 420]] = [2, 9, 2]
    elif name == "two_way_tie":      # two first-level bins, equal totals
        h[[100, 101, 420]] = [3, 2, 5]
    elif name == "sub_tie":          # one winning bin, its sub-bins tie
        h[[100, 420]] = 1
        h[[250, 259]] = 6
    elif name == "even_median":      # ranks n/2 and n/2 + 1 differ
        h[[10, 630]] = 1
        h[[286, 292, 293, 306]] = [1, 2, 2, 1]
    elif name == "edges":            # values at the first and last bin
        h[[0, 2, W - 1]] = [4, 5, 1]
    return W, H, h


CRAFTED = ["empty", "one_value", "one_bin", "sub_hi_eq_lo", "two_way_tie",
           "sub_tie", "even_median", "edges"]


def test_intercept_z_matches_jax_on_crafted_and_random_rows():
    rows = [_crafted(n)[2] for n in CRAFTED]
    rng = np.random.default_rng(5)
    for b in range(6):                 # a diagonal band, as kept hits make
        h = np.zeros(640, np.int32)
        idx = np.clip(rng.normal(256 + 20 * b, 3 + 4 * b, 40 * (b + 1)),
                      0, 639).astype(int)
        np.add.at(h, idx, 1)
        rows.append(h)
    h = np.stack(rows)
    found, z = kernels.intercept_z(torch.from_numpy(h), 256, 256)
    assert found.dtype == torch.bool and z.dtype == torch.int64
    for b in range(h.shape[0]):
        j_found, j_z = jf.intercept_z_device(jnp.asarray(h[b]), 256)
        assert (bool(found[b]), int(z[b])) == (bool(j_found), int(j_z)), b
    got = {n: bool(found[i]) for i, n in enumerate(CRAFTED)}
    assert got == {n: n not in ("empty", "two_way_tie", "sub_tie")
                   for n in CRAFTED}
    assert int(found[len(CRAFTED):].sum()) > 0


# ---------------------------------------------------------------------------
# argument checks
# ---------------------------------------------------------------------------

HAPS, READS, RLENS = (torch.from_numpy(x)
                      for x in random_rows(128, 96, 3, seed=1)[:3])
HIST = torch.zeros((3, hist_width(128, 96)), dtype=torch.int32)


def _meta(t):
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


@pytest.mark.parametrize("args, match", [
    ((HAPS, READS, RLENS, 15), "k must be 10, 20, 30 or 40"),
    ((HAPS[0], READS, RLENS, 10), "want \\(U, H\\) haps"),
    ((HAPS.int(), READS, RLENS, 10), "haps: want torch.uint8"),
    ((HAPS, READS, RLENS.long(), 10), "rlens: want torch.int32"),
    ((HAPS, READS, RLENS[:2], 10), "rlens: want"),
    ((HAPS, READS.t().contiguous().t(), RLENS, 10),
     "reads must be contiguous"),
    ((HAPS, READS, _meta(RLENS), 10), "rlens is on meta, reads on cpu"),
    ((HAPS, READS, RLENS, 10, torch.zeros(3, dtype=torch.int32)),
     "hap_index: want torch.int64"),
    ((HAPS, READS, RLENS, 10, torch.zeros(2, dtype=torch.int64)),
     "hap_index: want"),
    ((_meta(HAPS), _meta(READS), _meta(RLENS), 10),
     "unsupported device meta"),
])
def test_row_codes_rejects_bad_arguments(args, match):
    with pytest.raises(ValueError, match=match):
        kernels.row_codes(*args)


@pytest.mark.parametrize("index, rlen", [(3, 50), (-1, 50), (1, 97),
                                         (1, -1)])
def test_row_codes_raises_on_out_of_range_rows(index, rlen):
    """A hap index outside [0, U) or a read length outside [0, R] raises
    on the CPU, in the plain version's index_select or gather (codes.cu
    stops on a device assert there: tests/test_torch_cuda.py)."""
    rlens = RLENS.clone()
    rlens[1] = rlen
    hap_index = torch.tensor([0, index, 2])
    with pytest.raises((IndexError, RuntimeError)):
        kernels.row_codes(HAPS, READS, rlens, 10, hap_index)


@pytest.mark.parametrize("hs, specs, kw, match", [
    ((), (), {}, "want 1 to 4 histograms"),
    ((HIST,) * 5, ((10, False),) * 5, {}, "want 1 to 4 histograms"),
    ((HIST, HIST), ((10, False),), {}, "one \\(thr, fallback_max\\)"),
    ((HIST.long(),), ((10, False),), {}, "hist0: want torch.int32"),
    ((HIST, HIST[:2]), ((10, False),) * 2, {}, "hist1: want"),
    ((HIST, _meta(HIST)), ((10, False),) * 2, {}, "hist1 is on meta"),
    ((HIST[:, ::2],), ((10, False),), {}, "hist0 must be contiguous"),
    ((HIST[0],), ((10, False),), {}, "want \\(B, W\\) histograms"),
    ((HIST,), ((10, False),), {"gap": 0}, "gap 0 at width"),
    ((HIST,), ((10, False),), {"R": 512}, "not those of H=128"),
])
def test_kept_tables_reject_bad_arguments(hs, specs, kw, match):
    with pytest.raises(ValueError, match=match):
        kernels.kept_tables(hs, specs, **{"H": 128, "R": 96, **kw})


@pytest.mark.parametrize("args, kw, match", [
    ((HIST.long(), 128), {}, "hist: want torch.int32"),
    ((HIST[0], 128), {}, "want \\(B, W\\) histograms"),
    ((HIST[:, ::2], 128), {}, "hist must be contiguous"),
    ((HIST, 1024), {}, "not those of H=1024"),
    ((HIST, 128), {"R": 4096}, "not those of H=128"),
    ((_meta(HIST), 128), {}, "unsupported device meta"),
])
def test_intercept_z_rejects_bad_arguments(args, kw, match):
    with pytest.raises(ValueError, match=match):
        kernels.intercept_z(*args, **{"R": 96, **kw})


# ---------------------------------------------------------------------------
# the card branch, on CPU tensors
# ---------------------------------------------------------------------------

CALLS = {
    "row_codes": ((HAPS[:1].contiguous(), READS, RLENS, 20,
                   torch.zeros(3, dtype=torch.int64)), {}),
    "kept_tables": (((HIST, HIST, HIST), ((10, False), (10, False),
                                          (50, True)), 128, 96), {}),
    "intercept_z": ((HIST, 128, 96), {}),
}


@pytest.fixture
def card_branch(monkeypatch):
    """The wrappers take their card branch on CPU tensors, and every
    plain version raises if it is called."""
    monkeypatch.setattr(kernels, "_plain", lambda t: False)
    for name in kernels.ALL_NAMES + ("hist_self",):
        def refuse(*a, _name=name, **kw):
            raise AssertionError(f"{_name}'s plain version ran")
        monkeypatch.setattr(kernels, f"{name}_plain", refuse)


@pytest.mark.parametrize("name", kernels.GLUE_NAMES)
def test_a_card_call_that_cannot_launch_raises(card_branch, monkeypatch,
                                               name):
    """No card (an entry point that cannot be had), or an entry point
    that returns a CUDA error: the wrapper raises, counts nothing and
    runs no plain version."""
    monkeypatch.setattr(kernels, "_ENTRY", {})

    def no_card(*a, **kw):
        raise RuntimeError("no CUDA toolkit found")
    monkeypatch.setattr(build, "entry_point", no_card)
    args, kw = CALLS[name]
    launched = dict(kernels.LAUNCHES)
    with pytest.raises(RuntimeError, match="no CUDA toolkit"):
        getattr(kernels, name)(*args, **kw)
    monkeypatch.setattr(kernels, "_ENTRY", {(name, "glue"): lambda *a: 700})
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 0, raising=False)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        getattr(kernels, name)(*args, **kw)
    assert kernels.LAUNCHES == launched


@pytest.mark.parametrize("name", kernels.GLUE_NAMES)
def test_launch_records_the_entry_points_arguments(card_branch, name):
    """timing._Launch on a glue wrapper's card branch: route "glue", the
    C entry point build binds, one argument per argtype (the card's
    index and stream apart), and outputs allocated with torch.empty and
    returned as the kernel's views of them."""
    args, kw = CALLS[name]
    held = {}
    launch = timing._Launch(lambda: held.setdefault(
        "out", getattr(kernels, name)(*args, **kw)))
    assert (launch.name, launch.route) == (name, "glue")
    source, symbol, argtypes = build.GLUE_POINTS[name]
    assert build.source(name) == f"{source}.cu" and \
        symbol == f"vt_{name}"
    assert len(launch.pointers) + 2 == len(argtypes)
    out = held["out"]
    if name == "row_codes":
        assert launch.pointers[3] == args[4].data_ptr()
        assert launch.pointers[4:10] == [1, 3, 128, 96, 3, 20]
        assert [t.shape for t in out] == [(3, 3, 128), (3, 3, 96),
                                          (3, 3, 96)]
        assert launch.pointers[10:] == [t.data_ptr() for t in out]
    elif name == "kept_tables":
        buf = launch.args[0]
        assert buf.shape == (3,) + tuple(HIST.shape)
        assert launch.pointers[1:5] == [HIST.data_ptr()] * 3 + [None]
        assert launch.pointers[5:] == [10, 10, 50, 0, 0b100, 3, 3,
                                       HIST.shape[1], 10]
        assert [t.data_ptr() for t in out] == [
            buf[t].data_ptr() for t in range(3)]
    else:
        found, z = out
        assert launch.pointers[:4] == [HIST.data_ptr(), 3, HIST.shape[1],
                                       128]
        assert launch.pointers[4:] == [z.data_ptr(), found.data_ptr()]
        assert z.dtype == torch.int64 and found.dtype == torch.bool
        assert found.data_ptr() == z.data_ptr() + 8 * 3


def _glue_launches(call, monkeypatch):
    """The glue kernels `call` launches on the card branch (the six's
    launches recorded and dropped), by name."""
    seen = []
    monkeypatch.setattr(kernels, "_launch", lambda *a, **kw: None)
    monkeypatch.setattr(kernels, "_launch_glue",
                        lambda name, shape, *a: seen.append((name, shape)))
    call()
    return seen


@pytest.mark.parametrize("mode, tables", [("m1b", 1), ("rdd", 1),
                                          ("del", 2), ("w10", 2)])
def test_fused_rows_launches_the_glue_kernels(card_branch, monkeypatch,
                                              mode, tables):
    """fused_rows on the card: one row_codes launch, kept_tables once
    (m1b, rdd) or twice (del: kd, ka and kd50 together, then ka50; w10:
    kd50, then ka50), intercept_z once for rdd, each counted under the
    batch's (H, R); no plain version runs."""
    haps, reads, rlens, ms = random_rows(128, 96, 3, seed=1)
    h, r, rl, m, _ = tf.batch_from_numpy(haps, reads, rlens, ms, 0, "cpu")
    seen = _glue_launches(lambda: tf.fused_rows(h, r, rl, m, 10, mode),
                          monkeypatch)
    want = [("row_codes", (128, 96))] + \
        [("kept_tables", (128, 96))] * tables
    if mode == "rdd":
        want.append(("intercept_z", (128, 96)))
    assert seen == want


def test_self_stats_rows_launch_row_codes(card_branch, monkeypatch):
    lengths = torch.tensor([40, 60, 128], dtype=torch.int32)
    seen = _glue_launches(lambda: window_device.self_stats_rows(
        HAPS, lengths, 10), monkeypatch)
    assert seen == [("row_codes", (128, 128))]


# ---------------------------------------------------------------------------
# bookkeeping
# ---------------------------------------------------------------------------

def test_capture_records_the_glue_calls_by_shape():
    haps, reads, rlens, ms = random_rows(128, 96, 3, seed=2)
    h, r, rl, m, _ = tf.batch_from_numpy(haps, reads, rlens, ms, 0, "cpu")
    store = {}
    with timing.capture(store):
        tf.fused_batch_local(h[:1].contiguous(), r, rl, m, 0, "rdd",
                             torch.zeros(3, dtype=torch.int64))
    glue = {key: v for key, v in store.items() if key[1] == "glue"}
    assert set(glue) == {(n, "glue", 128, 96) for n in kernels.GLUE_NAMES}
    args, kwargs = glue["kept_tables", "glue", 128, 96]
    assert kwargs == {} and args[2:] == (128, 96) and len(args[0]) == 2
    replay = kernels.kept_tables(*args, **kwargs)
    assert all(t.dtype == torch.bool for t in replay)
    rolled = timing.rolled(args)
    assert torch.equal(rolled[0][0], args[0][0].roll(1, 0))
    assert rolled[1] == args[1]


def test_capture_and_rolled_keep_a_histogram_given_twice():
    """fused_rows' del launch gives h_d twice (its kd and kd50 tables):
    the recorded call and its rolled copy hold one tensor there, so the
    launch's bound counts h_d's bytes once."""
    haps, reads, rlens, ms = random_rows(128, 96, 3, seed=2)
    h, r, rl, m, _ = tf.batch_from_numpy(haps, reads, rlens, ms, 0, "cpu")
    store = {}
    with timing.capture(store):
        tf.fused_batch_local(h, r, rl, m, 0, "del")
    args, _ = store["kept_tables", "glue", 128, 96]
    hs = args[0]
    assert len(hs) == 3 and hs[0] is hs[2] and hs[0] is not hs[1]
    second = timing.rolled(args)[0]
    assert second[0] is second[2] and torch.equal(second[0],
                                                  hs[0].roll(1, 0))
    nbytes, _ = roofline.kept_tables_work(hs, kernels.kept_tables(*args))
    assert nbytes == (2 * 4 + 3) * hs[0].numel()


def test_work_counts():
    h, r, rl = HAPS, READS, RLENS
    out = kernels.row_codes(h, r, rl, 10)
    nbytes, ops = roofline.codes_work(h, r, rl, out, 10)
    assert nbytes == h.numel() + r.numel() + 4 * 3 + 4 * 2 * 3 * (128 + 192)
    assert ops == 2 * 10 * 3 * (128 + 2 * 96)
    specs = ((10, False), (50, True))
    other = HIST.clone()
    tables = kernels.kept_tables((HIST, other), specs, 128, 96)
    assert roofline.kept_tables_work((HIST, other), tables) == (
        2 * 5 * HIST.numel(), 2 * roofline.KEPT_OPS_PER_BIN * HIST.numel())
    # one histogram given twice is read once, as fused_rows' del launch
    # gives h_d (its kd and kd50 tables)
    tables = kernels.kept_tables((HIST, HIST), specs, 128, 96)
    assert roofline.kept_tables_work((HIST, HIST), tables) == (
        (4 + 2) * HIST.numel(), 2 * roofline.KEPT_OPS_PER_BIN * HIST.numel())
    hh = HIST.clone()
    hh[0, 5] = hh[1, 7] = 2
    got = kernels.intercept_z(hh, 128, 96)
    assert roofline.intercept_work(hh, got) == (
        4 * hh.numel() + 3 * 9,
        roofline.INTERCEPT_OPS_PER_BIN * hh.numel() +
        2 * roofline.INTERCEPT_OPS_PER_VALUE)


def _c_table(src, name):
    body = re.search(rf"__constant__ uint8_t {name}\[256\] = \{{(.*?)\}};",
                     src, re.S).group(1)
    return np.array([int(x) for x in body.replace(",", " ").split()])


def test_codes_source_tables_are_the_python_ones():
    """codes.cu's NIB is constants.NIB_LUT, its NIBC is NIB of
    oracle._COMP_LUT, and its pads are constants.HAP_PAD and READ_PAD."""
    with open(os.path.join(build.CSRC, "codes.cu")) as fh:
        src = fh.read()
    assert np.array_equal(_c_table(src, "NIB"), NIB_LUT)
    assert np.array_equal(_c_table(src, "NIBC"), NIB_LUT[oracle._COMP_LUT])
    assert f"constexpr int HAP_PAD = {HAP_PAD};" in src
    assert f"constexpr int READ_PAD = {READ_PAD};" in src


@pytest.mark.parametrize("name", kernels.GLUE_NAMES)
def test_glue_sources_define_their_entry_points(name):
    """Each glue kernel's source defines the C entry point build binds,
    with one parameter per argtype, and launches a kernel named
    <name>_kernel (the name the profiles match)."""
    with open(os.path.join(build.CSRC, build.source(name))) as fh:
        src = fh.read()
    _, symbol, argtypes = build.GLUE_POINTS[name]
    at = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', src)
    assert at and len(at.group(1).split(",")) == len(argtypes)
    assert re.search(rf"\b{name}_kernel<<<", src)
    assert name in build.build.__defaults__[0]
