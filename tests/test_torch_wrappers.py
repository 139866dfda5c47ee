"""vapor_tpu_torch's kernel wrappers on the CPU (engine/kernels/__init__.py
and timing.py), beside what test_torch_fused.py holds against JAX:

* every argument check of every wrapper raises as it says, for each
  wrapper (hist's self-stats route included);
* the card branch of a wrapper, driven on CPU tensors with
  ``kernels._plain`` patched and its launch recorded by ``timing._Launch``
  instead of made: the route, the arguments the C entry point gets, and
  no fill (every entry point zeroes the outputs itself, so each wrapper
  allocates them with one ``torch.empty``);
* hist's scal, whose first and last hit rows are encoded so that zero is
  the identity, through ``kernels.hist_scal`` against the JAX engine's
  FusedStats of ``_fused_batch_jit``, exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vapor_tpu.engine import fused as jf
from vapor_tpu.engine.fused import FusedStats as JaxStats
from vapor_tpu_torch.engine import fused as tf
from vapor_tpu_torch.engine import kernels
from vapor_tpu_torch.engine.constants import hist_width
from vapor_tpu_torch.engine.kernels import build, timing
from torch_rows import random_rows

H, R, B = 256, 192, 3


def _codes(k=10, seed=9):
    batch = random_rows(H, R, B, seed=seed, ms=(0, 23))
    h, r, rl, ms, _ = tf.batch_from_numpy(*batch, k // 10 - 1, "cpu")
    return (*tf.row_codes(h, r, rl, k), ms, rl, k)


CODES = _codes()
KEEP = torch.zeros((B, hist_width(H, R)), dtype=torch.bool)
Z = torch.zeros(B, dtype=torch.int32)
# wrapper -> the arguments it takes after the codes
TAILS = {"hist": (), "hist_self": (), "left_hist": (KEEP,),
         "kept_hist": (KEEP, KEEP), "moment": (KEEP, KEEP, False),
         "moment2": (KEEP, KEEP, KEEP, KEEP), "rdd_moment": (KEEP, KEEP, Z)}


def _swap(codes, at, value):
    out = list(codes)
    out[at] = value
    return tuple(out)


def _meta(t):
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


ch, cf, cd, ms, rl, k = CODES
# (codes, message) of each check on the codes
CODE_ERRORS = {
    "k": (_swap(CODES, 5, 15), "k must be 10, 20, 30 or 40"),
    "lanes": (_swap(CODES, 5, 20), "k=20 needs 3 code lanes, got 2"),
    "ch rank": (_swap(CODES, 0, ch[0]), "ch must be"),
    "ch dtype": (_swap(CODES, 0, ch.long()), "ch: want torch.int32"),
    "cf shape": (_swap(CODES, 1, cf[:-1]), "cf: want"),
    "cd layout": (_swap(CODES, 2, cd.transpose(1, 2).contiguous()
                        .transpose(1, 2)), "cd must be contiguous"),
    "ms dtype": (_swap(CODES, 3, ms.long()), "ms: want"),
    "rlens shape": (_swap(CODES, 4, rl[:-1]), "rlens: want"),
    "device": (_swap(CODES, 3, _meta(ms)), "ms is on meta, ch on cpu"),
    "unsupported": ((*(_meta(x) for x in CODES[:5]), k),
                    "unsupported device meta"),
}


@pytest.mark.parametrize("error", sorted(CODE_ERRORS))
@pytest.mark.parametrize("wrapper", sorted(TAILS))
def test_wrappers_reject_bad_codes(wrapper, error):
    codes, match = CODE_ERRORS[error]
    tail = TAILS[wrapper]
    if error == "unsupported":      # every tensor on the meta device
        tail = tuple(_meta(t) if isinstance(t, torch.Tensor) else t
                     for t in tail)
    with pytest.raises(ValueError, match=match):
        getattr(kernels, wrapper)(*codes, *tail)


@pytest.mark.parametrize("wrapper, at, bad, match", [
    ("left_hist", 0, KEEP.int(), "table0: want torch.bool"),
    ("kept_hist", 1, KEEP[:, :-1], "table1: want"),
    ("moment", 0, _meta(KEEP), "table0 is on meta"),
    ("moment2", 3, KEEP.t().contiguous().t(), "table3 must be contiguous"),
    ("rdd_moment", 2, Z.long(), "z: want torch.int32"),
    ("rdd_moment", 1, KEEP[:-1], "table1: want"),
])
def test_wrappers_reject_bad_tables(wrapper, at, bad, match):
    tail = _swap(TAILS[wrapper], at, bad)
    with pytest.raises(ValueError, match=match):
        getattr(kernels, wrapper)(*CODES, *tail)


@pytest.mark.parametrize("wrapper", sorted(TAILS))
def test_wrappers_run_plain_on_cpu_without_launching(wrapper):
    launched = dict(kernels.LAUNCHES)
    shapes = dict(kernels.LAUNCH_SHAPES)
    plain = getattr(kernels, f"{wrapper}_plain")(*CODES, *TAILS[wrapper])
    got = getattr(kernels, wrapper)(*CODES, *TAILS[wrapper])
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    plain if isinstance(plain, tuple) else (plain,)):
        assert torch.equal(g, w)
    assert kernels.LAUNCHES == launched and \
        dict(kernels.LAUNCH_SHAPES) == shapes


@pytest.fixture
def card_branch(monkeypatch):
    """The wrappers take their card branch on CPU tensors; only
    timing._Launch may call them here, which records the launch instead
    of making it."""
    monkeypatch.setattr(kernels, "_plain", lambda t: False)


def _noting(made, what, real):
    """`real`, noting `what` in `made` at each call (a function, so that
    it binds as a method where it replaces one)."""
    def noted(*args, **kwargs):
        made.append(what)
        return real(*args, **kwargs)
    return noted


@pytest.mark.parametrize("wrapper", sorted(TAILS))
def test_launch_records_route_arguments_and_fills(card_branch, wrapper,
                                                  monkeypatch):
    """timing._Launch on each wrapper's card branch: the kernel and route
    of kernels.ROUTES, an entry point of build's with one argument a
    pointer (the card's index and stream apart), and no fill: the C
    entry point zeroes the outputs itself, so the wrapper allocates them
    with one torch.empty, and neither makes zeros nor fills a tensor."""
    made = []
    with monkeypatch.context() as patch:
        for what in ("empty", "zeros", "zeros_like", "full", "full_like"):
            patch.setattr(torch, what,
                          _noting(made, what, getattr(torch, what)))
        for what in ("zero_", "fill_", "copy_"):
            patch.setattr(torch.Tensor, what,
                          _noting(made, what, getattr(torch.Tensor, what)))
        launch = timing._Launch(lambda: getattr(kernels, wrapper)(
            *CODES, *TAILS[wrapper]))
    assert made == ["empty"]
    assert kernels.ROUTES[launch.name, launch.route] == wrapper
    symbol, argtypes = build.ROUTE_POINTS.get(
        (launch.name, launch.route), build.ENTRY_POINTS[launch.name])
    assert symbol == ("vt_hist_self" if wrapper == "hist_self"
                      else f"vt_{launch.name}")
    assert len(launch.pointers) + 2 == len(argtypes)
    assert launch.args[0] is CODES[0] and launch.index == -1
    assert launch.pointers[:5] == [x.data_ptr() for x in CODES[:5]]
    assert launch.pointers[5:10] == [B, H, R, 2, 10]


def test_hist_card_branch_views_one_buffer(card_branch):
    """hist's outputs on its card branch are views of the one buffer the
    entry point gets (and zeroes): [h_d | h_a | scal]; hist_self's is
    the (B, 3) int64 output itself."""
    held = {}
    launch = timing._Launch(lambda: held.setdefault(
        "out", kernels.hist(*CODES)))
    h_d, h_a, scal = held["out"]
    buf = launch.args[-1]
    W = hist_width(H, R)
    assert buf.dtype == torch.int32 and buf.numel() == (2 * W + 4) * B
    assert launch.pointers[10] == W
    for view, shape, offset in ((h_d, (B, W), 0), (h_a, (B, W), B * W),
                                (scal, (B, 4), 2 * B * W)):
        assert view.shape == shape and view.is_contiguous()
        assert view.data_ptr() == buf.data_ptr() + 4 * offset
    launch = timing._Launch(lambda: held.setdefault(
        "self", kernels.hist_self(*CODES)))
    assert launch.route == "selfstats" and launch.args[-1] is held["self"]
    assert held["self"].shape == (B, 3) and \
        held["self"].dtype == torch.int64


@pytest.mark.parametrize("k_idx", [0, 1, 2, 3])
def test_hist_scal_matches_jax_fused_stats(k_idx):
    """hist's encoded scal (plain version: the kernel's bits) through
    hist_scal against FusedStats of the JAX engine's _fused_batch_jit:
    hit count, first and last hit row, on rows with hits and a row with
    m past every hit (first row H + 1, last -1)."""
    k = 10 * (k_idx + 1)
    haps, reads, rlens, ms = random_rows(H, R, 4, seed=k, ms=(0, 23),
                                         err=0.02)
    ms[1] = H - 2
    h, r, rl, m, _ = tf.batch_from_numpy(haps, reads, rlens, ms, k_idx,
                                         "cpu")
    _, _, scal = kernels.hist(*tf.row_codes(h, r, rl, k), m, rl, k)
    assert scal[1].tolist() == [0, 0, 0, 0]       # the identity
    got = kernels.hist_scal(scal, H).numpy()
    _, _, packed = jf._fused_batch_jit(
        jnp.asarray(haps), jnp.asarray(reads), None, jnp.asarray(rlens),
        jnp.asarray(ms), jnp.int32(k_idx), H=H, R=R, scorer="m1b",
        want_hists=True)
    js = JaxStats(None, None, packed)
    assert np.array_equal(got[:, 0] + got[:, 1], js.n_dots)
    assert np.array_equal(got[:, 2], js.i_min)
    assert np.array_equal(got[:, 3], js.i_max)
    assert got[1].tolist() == [0, 0, H + 1, -1]
    assert got[0, 0] > 0
