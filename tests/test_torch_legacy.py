"""vapor_tpu_torch.engine.legacy and the oracle's directed_m1b scorer
against vapor_tpu's: every public function of the port's legacy module
gives vapor_tpu's result, exactly, on seeded inputs."""
import random

import numpy as np
import pytest

from vapor_tpu.engine import legacy as jl
from vapor_tpu.engine import oracle as jo
from vapor_tpu_torch.engine import legacy as tl
from vapor_tpu_torch.engine import oracle as to


def _dots(rng, n, spread=2000):
    return [(rng.randint(0, spread), rng.randint(0, spread))
            for _ in range(n)]


def _line_dots(rng):
    """A dot cloud with three embedded line segments."""
    dots = []
    for _ in range(3):
        x0, y0 = rng.randint(0, 800), rng.randint(0, 800)
        dots += [(x0 + t, y0 + t) for t in range(rng.randint(15, 60))]
    return dots + _dots(rng, 30, spread=900)


def test_public_functions_are_the_same_set():
    def public(mod):
        return {n for n, v in vars(mod).items()
                if callable(v) and not n.startswith("_") and
                getattr(v, "__module__", "") == mod.__name__}
    assert public(tl) == public(jl)
    assert len(public(tl)) == 18


def test_edit_distance():
    rng = random.Random(1)
    for _ in range(12):
        a = "".join(rng.choice("ACGT") for _ in range(rng.randint(0, 14)))
        b = "".join(rng.choice("ACGT") for _ in range(rng.randint(0, 14)))
        assert tl.edit_distance(a, b) == jl.edit_distance(a, b)


@pytest.mark.parametrize("seed", [2, 3])
def test_directed_and_regression_metrics(seed):
    rng = random.Random(seed)
    for _ in range(8):
        dots = _dots(rng, rng.randint(1, 200))
        dots.append((0, rng.randint(0, 50)))      # the i == 0 branch
        for fn in ("eu_dis_dir_calcu", "eu_y_vs_x_ratio_calcu",
                   "eu_dis_reg_calcu"):
            assert getattr(tl, fn)(dots) == getattr(jl, fn)(dots), fn
        for d in dots[:20]:
            assert tl.eu_dis_single_dot(d) == jl.eu_dis_single_dot(d)
    # no dot within 0.15 of the diagonal, and a single ratio
    assert tl.eu_y_vs_x_ratio_calcu([(10, 100)]) == \
        jl.eu_y_vs_x_ratio_calcu([(10, 100)])
    assert tl.eu_dis_reg_calcu([(100, 101), (200, 202)]) == \
        jl.eu_dis_reg_calcu([(100, 101), (200, 202)])


def test_region_metrics(capsys):
    rng = random.Random(3)
    for _ in range(6):
        dots = sorted(_dots(rng, 80, spread=1000))
        bps = sorted(rng.sample(range(0, 1000), 4))
        assert tl.eu_dis_region_calcu(dots, bps) == \
            jl.eu_dis_region_calcu(dots, bps)
        theirs, ours = capsys.readouterr().out.splitlines()[-2:]
        assert ours == theirs                  # the stray region print
        for blocks in ([[100, 300], [500, 800]], [[0, 50], [900, 999]]):
            assert tl.eu_dis_reg_dup_block_calcu(dots, blocks) == \
                jl.eu_dis_reg_dup_block_calcu(dots, blocks)


def test_line_recognizers():
    rng = random.Random(4)
    for _ in range(5):
        dots = _line_dots(rng)
        assert tl.dot_to_line(dots) == jl.dot_to_line(dots)
        assert tl.dot_to_line(dots, 20, 5) == jl.dot_to_line(dots, 20, 5)
        assert tl.ref_ref_deviate_lines(dots) == \
            jl.ref_ref_deviate_lines(dots)
        for seg in tl.dot_to_line(dots):
            assert tl.kept_line_size_ok(seg) == jl.kept_line_size_ok(seg)
            assert tl.kept_line_size_ok(seg, 50) == \
                jl.kept_line_size_ok(seg, 50)


def test_cluster_by_gap():
    rng = random.Random(5)
    dim1 = [rng.randint(0, 300) for _ in range(120)]
    dim2 = [rng.randint(0, 300) for _ in range(120)]
    for gap, min_len in ((20, 5), (5, 1), (50, 30)):
        assert tl.one_dimension_cluster_by_gap(dim1, gap, min_len) == \
            jl.one_dimension_cluster_by_gap(dim1, gap, min_len)
        assert tl.two_dimension_cluster_by_gap(dim1, dim2, gap, min_len) \
            == jl.two_dimension_cluster_by_gap(dim1, dim2, gap, min_len)
    assert tl.one_dimension_cluster_by_gap([], 5, 1) == []


def test_inventory_stragglers():
    rng = random.Random(12)
    dots = sorted(_dots(rng, 120, spread=900))
    sym = dots[:10] + [(b, a) for a, b in reversed(dots[:10])]
    for ds in (dots, sym):
        tup = [tuple(d) for d in ds]
        assert tl.take_off_symmetric_dots(tup) == \
            jl.take_off_symmetric_dots(tup)
    hits = [(rng.randint(0, 10 ** 6), rng.randint(0, 10 ** 6))
            for _ in range(400)]
    assert tl.quality_filter(hits) == jl.quality_filter(hits)
    sv_info = ["chr1", 114103333, 114103408, "chr1", 114111746]
    for alt in (["a", "b", "a^"], ["a", "a^"], ["a", "b", "b", "a^"]):
        for flank in (75, 500):
            assert tl.dup_inv_ref_alt_bps(sv_info, flank, alt) == \
                jl.dup_inv_ref_alt_bps(sv_info, flank, alt)
            assert tl.dup_inv_dup_bps(sv_info, flank, alt) == \
                jl.dup_inv_dup_bps(sv_info, flank, alt)


def test_dot_dumps(tmp_path):
    rng = random.Random(13)
    ref, alt = _dots(rng, 30), _dots(rng, 20)
    for mod, d in ((tl, tmp_path / "t"), (jl, tmp_path / "j")):
        d.mkdir()
        mod.write_dotdata(str(d / "dots"), ref)
        mod.write_ref_alt_dotdata(str(d / "pair"), ref, alt)
    for name in ("dots", "pair.ref", "pair.alt"):
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes()


def test_directed_scorer():
    """score_directed_m1b through SCORERS: the port's equals vapor_tpu's
    on DUP, DEL and unrelated reads, and the gates' [0, 0] cases."""
    assert set(to.SCORERS) == set(jo.SCORERS)
    rng = random.Random(44)
    body = "".join(rng.choice("ACGT") for _ in range(140))
    left = "".join(rng.choice("ACGT") for _ in range(110))
    right = "".join(rng.choice("ACGT") for _ in range(110))
    ref_hap = left + body + right
    checked = 0
    for alt_hap in (left + body + body + right, left + right):
        for i in range(4):
            donor = alt_hap if i % 2 == 0 else ref_hap
            read = "".join(c for c in donor if rng.random() > 0.04)
            miss = rng.choice([0, 0, 9])
            want = jo.SCORERS["directed_m1b"](ref_hap, alt_hap, read, miss,
                                              10)
            got = to.SCORERS["directed_m1b"](ref_hap, alt_hap, read, miss,
                                             10)
            assert [float(x) for x in got] == [float(x) for x in want]
            checked += want != [0, 0]
    noise = "".join(rng.choice("ACGT") for _ in range(300))
    assert to.score_directed_m1b(ref_hap, ref_hap, noise, 0, 10) == \
        jo.score_directed_m1b(ref_hap, ref_hap, noise, 0, 10) == [0, 0]
    assert checked >= 2
    ii, jj, ww = (np.array([3, 5]), np.array([4, 8]), np.array([2, 1]))
    assert to._expand_pairs(ii, jj, ww) == jo._expand_pairs(ii, jj, ww) == \
        [[3, 4], [3, 4], [5, 8]]
