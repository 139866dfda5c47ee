"""Rows across devices (vapor_tpu_torch/parallel/mesh.py): one fused_batch
call's rows split over [cpu] * n gives, bit for bit, the one-device
fused_batch's packed rows and vapor_tpu's mesh path (8 virtual CPU
devices, tests/conftest.py), in every device mode and with the batching
backend's hap_index; small batches fall through; make_mesh checks its
factors; and the CLI's bytes do not change with the device list."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vapor_tpu.engine import fused as jf
from vapor_tpu.engine.fused import FusedStats as JaxStats
from vapor_tpu.parallel import mesh as jmesh
from vapor_tpu_torch.cli import main
from vapor_tpu_torch.engine import fused as tf
from vapor_tpu_torch.parallel import mesh as pmesh
from torch_rows import random_rows

H = R = 256
B = 20          # not a multiple of 8: the split pads
CPU = torch.device("cpu")
MODES = ("m1b", "w10", "del", "rdd")
FIELDS = {"m1b": (), "w10": (), "del": ("cnt2", "w10_2"),
          "rdd": ("sel_cnt", "sel_pos", "sel_neg")}


def _rows():
    return random_rows(H, R, B, seed=5, ms=(0, 23, 0, 140))


@functools.lru_cache(maxsize=None)
def _jax_mesh(scorer):
    """vapor_tpu's fused_batch on the 8-device CPU mesh: its rows go
    through parallel.mesh.maybe_mesh_rows."""
    haps, reads, rlens, ms = _rows()
    args = (jnp.asarray(haps), jnp.asarray(reads), None,
            jnp.asarray(rlens), jnp.asarray(ms), jnp.int32(0))
    assert jmesh.device_count() == 8
    assert jmesh.maybe_mesh_rows(*args, H=H, R=R, scorer=scorer,
                                 width=8) is not None
    _, _, packed = jf.fused_batch(*args, H=H, R=R, scorer=scorer)
    return JaxStats(None, None, packed)


def _torch_args(hap_index):
    haps, reads, rlens, ms = _rows()
    args = tf.batch_from_numpy(haps, reads, rlens, ms, 0, CPU)
    if not hap_index:
        return args, None
    # each row indexes one of the unique haps, as the batching backend
    # uploads them: rows 0, 7, 14 share hap 0, and so on
    idx = torch.arange(B) % 7
    return (args[0][:7], *args[1:]), idx


@pytest.mark.parametrize("hap_index", [False, True])
@pytest.mark.parametrize("n", [1, 2, 3, 8])
@pytest.mark.parametrize("scorer", MODES)
def test_split_over_cpus_is_bitwise(scorer, n, hap_index):
    (haps, reads, rlens, ms, k_idx), idx = _torch_args(hap_index)
    _, _, one = tf.fused_batch(haps, reads, rlens, ms, k_idx, H, R, scorer,
                               hap_index=idx)
    got = pmesh.maybe_mesh_rows(haps, reads, rlens, ms, k_idx, H, R, scorer,
                                hap_index=idx, devices=[CPU] * n)
    if n == 1:          # one device: fused_batch's one-device launch
        assert got is None
        return
    assert torch.equal(got, one)
    if hap_index:       # each row's hap in the row itself: the same rows
        full = haps.index_select(0, idx)
        assert torch.equal(tf.fused_batch(full, reads, rlens, ms, k_idx, H,
                                          R, scorer)[2], got)
        return
    ts, js = tf.FusedStats(None, None, got, scorer), _jax_mesh(scorer)
    for f in ("n_dots", "i_min", "i_max", "cnt", "sum_absd", "w10",
              *FIELDS[scorer]):
        assert np.array_equal(getattr(ts, f), getattr(js, f)), f
    assert int(ts.cnt.sum()) > 0


def test_fused_batch_splits_over_the_mesh_devices(monkeypatch):
    """fused_batch hands its rows to the split when mesh_devices names
    several devices, and returns no histograms then."""
    (haps, reads, rlens, ms, k_idx), idx = _torch_args(True)
    _, _, one = tf.fused_batch(haps, reads, rlens, ms, k_idx, H, R, "rdd",
                               hap_index=idx)
    monkeypatch.setattr(pmesh, "mesh_devices", lambda device: [CPU] * 3)
    h_d, h_a, got = tf.fused_batch(haps, reads, rlens, ms, k_idx, H, R,
                                   "rdd", hap_index=idx)
    assert h_d is None and h_a is None and torch.equal(got, one)


def test_small_batch_falls_through():
    haps, reads, rlens, ms, k_idx = tf.batch_from_numpy(
        *random_rows(192, 192, 4, seed=2), 0, CPU)
    assert pmesh.maybe_mesh_rows(haps, reads, rlens, ms, k_idx, 192, 192,
                                 "m1b", devices=[CPU] * 8) is None
    # CPU rows get no devices of their own: the one-device launch
    assert pmesh.mesh_devices(CPU) == []
    assert pmesh.maybe_mesh_rows(haps, reads, rlens, ms, k_idx, 192, 192,
                                 "m1b") is None


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_make_mesh_topologies(n):
    grid = pmesh.make_mesh(n, devices=[CPU] * 8)
    assert len(grid) == n and all(row == [CPU] for row in grid)
    assert [len(x) for x in pmesh.make_mesh(8, dp=4, sp=2,
                                            devices=[CPU] * 8)] == [2] * 4


def test_make_mesh_checks_its_factors():
    for kw in ({"dp": 3}, {"sp": 3}, {"dp": 2, "sp": 2}):
        with pytest.raises(ValueError, match="must equal"):
            pmesh.make_mesh(8, devices=[CPU] * 8, **kw)
    with pytest.raises(ValueError, match="available"):
        pmesh.make_mesh(4, devices=[CPU] * 2)


def test_device_count_honours_the_switches(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.delenv("VAPOR_MESH", raising=False)
    monkeypatch.delenv("VAPOR_MESH_DEVICES", raising=False)
    assert pmesh.device_count() == 4
    assert pmesh.mesh_devices(torch.device("cuda")) == [
        torch.device("cuda", i) for i in range(4)]
    monkeypatch.setenv("VAPOR_MESH_DEVICES", "2")
    assert pmesh.device_count() == 2
    monkeypatch.setenv("VAPOR_MESH", "0")
    assert pmesh.device_count() == 1


def test_cli_bytes_do_not_change_with_the_device_list(tmp_path,
                                                      monkeypatch):
    """The bed CLI on the CPU with fused_batch's rows split over 1, 2 and
    3 devices (monkeypatched device list): the same bytes each time."""
    from vapor_tpu.sim.synth import build_test_case
    case = build_test_case(str(tmp_path), genome_len=14000,
                           sv=("DEL", 6000, 6300), n_donor=6, n_ref=6,
                           read_len=1700, err=0.07, seed=21, het=True)
    bed = tmp_path / "svs.bed"
    bed.write_text("chrS\t6000\t6300\tSV1\tDEL\n"
                   "chrS\t6000\t6300\tSV2\tINV\n"
                   "chrS\t6000\t6250\tSV3\tDUP\n")
    split = []
    real = pmesh.maybe_mesh_rows

    def spy(*a, **kw):
        out = real(*a, **kw)
        split.append(out is not None)
        return out
    monkeypatch.setattr(tf, "maybe_mesh_rows", spy)
    outs = []
    for n in (1, 2, 3):
        monkeypatch.setattr(pmesh, "mesh_devices",
                            lambda device, n=n: [CPU] * n)
        split.clear()
        out = str(tmp_path / f"out_{n}.vapor")
        assert main(["bed", "--sv-input", str(bed), "--reference",
                     case["fasta"], "--pacbio-input", case["bam"],
                     "--output-path", str(tmp_path / "figs"),
                     "--output-file", out, "--device", "cpu",
                     "--no-figures"]) == 0
        assert split and any(split) == (n > 1)
        with open(out, "rb") as fh:
            outs.append(fh.read())
    assert outs[0] == outs[1] == outs[2]
    assert b"DEL" in outs[0] and outs[0].count(b"\n") == 4


@pytest.mark.parametrize("env,cards", [
    ({}, [0, 1]),                                   # one process: both
    ({"WORLD_SIZE": "2"}, [1]),                     # a torchrun rank
    ({"WORLD_SIZE": "1", "LOCAL_WORLD_SIZE": "4"}, [1]),   # a scatter shard
])
def test_one_card_per_process(monkeypatch, env, cards):
    """A process that is one of several (a torchrun rank, a scatter shard)
    splits its rows over its own card only; a process alone on the host
    splits over every card."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    for name in ("WORLD_SIZE", "LOCAL_WORLD_SIZE", "VAPOR_MESH",
                 "VAPOR_MESH_DEVICES"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    assert pmesh.mesh_devices(torch.device("cuda", 1)) == [
        torch.device("cuda", i) for i in cards]
    assert pmesh.mesh_devices(CPU) == []
