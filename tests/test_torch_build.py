"""vapor_tpu_torch's kernel build cache and bindings, the walks'
bookkeeping and their sentinels, on the CPU (no nvcc needed).

* build.library_path names a kernel's library by a hash of the flags,
  its source and every header in csrc/, so an edited header is never
  served from a stale library.
* Every kernel source includes csrc/walk.cuh, the one header in csrc/,
  and defines the C symbols that build binds, its grid query among them.
* Every (kernel, route) runs walk.cuh's on-chip walk, its C entry point
  zeroes the outputs (so its wrapper allocates them with torch.empty and
  fills nothing) and chip_smoke.py splits its floor (FLOOR_OF); no
  source still holds the strip walk that the on-chip walk replaced.
* csrc/walk.cuh masks rows and columns with sentinel code words; no
  code on the other side of a compare may hold them, or a masked cell
  would wake the walk's fast path (the rare path re-tests the bounds,
  so counts would stay exact, but slow).
"""
import ast
import inspect
import os
import re
import shutil

import numpy as np
import pytest
import torch

from vapor_tpu_torch.engine import fused, oracle
from vapor_tpu_torch.engine.constants import HAP_PAD, NIB_LUT, READ_PAD
from vapor_tpu_torch.engine import kernels
from vapor_tpu_torch.engine.kernels import build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A private copy of csrc/ that build reads in place of the real one."""
    root = str(tmp_path / "csrc")
    shutil.copytree(build.CSRC, root)
    monkeypatch.setattr(build, "CSRC", root)
    return root


def _touch(path):
    with open(path, "a") as fh:
        fh.write("\n// edited\n")


def _rename(path):
    os.rename(path, path[:-len(".cuh")] + "_old.cuh")


@pytest.mark.parametrize("header, change", [
    ("walk.cuh", _touch),     # a header edited
    ("new.cuh", _touch),      # a header added
    ("walk.cuh", _rename),    # a header renamed, its bytes unchanged
])
def test_library_path_follows_every_header(csrc, header, change):
    before = {n: build.library_path(n) for n in build.ENTRY_POINTS}
    change(os.path.join(csrc, header))
    after = {n: build.library_path(n) for n in build.ENTRY_POINTS}
    assert all(before[n] != after[n] for n in build.ENTRY_POINTS)


def test_library_path_follows_its_own_source_only(csrc):
    before = {n: build.library_path(n) for n in build.ENTRY_POINTS}
    _touch(os.path.join(csrc, "moment.cu"))
    after = {n: build.library_path(n) for n in build.ENTRY_POINTS}
    assert [n for n in build.ENTRY_POINTS if before[n] != after[n]] == \
        ["moment"]


@pytest.mark.parametrize("name", sorted(build.ENTRY_POINTS))
def test_kernel_source_walks_one_header_and_defines_its_symbols(name):
    """Every kernel includes walk.cuh (its on-chip walk) and defines
    each C symbol build binds, its launch and its grid query (nvcc and
    the card are not needed to see either)."""
    with open(os.path.join(build.CSRC, f"{name}.cu")) as fh:
        src = fh.read()
    assert re.findall(r'#include "(\w+\.cuh)"', src) == ["walk.cuh"]
    for symbol in (build.ENTRY_POINTS[name][0], build.GRID_POINTS[name]):
        assert re.search(rf'extern "C" int {symbol}\(', src), symbol


@pytest.mark.parametrize("name, route", sorted(build.ROUTE_POINTS))
def test_route_entry_points_live_in_their_kernels_source(name, route):
    """A route with an entry point of its own (hist's self-stats rows)
    defines it, and its grid query, in its kernel's source, so that the
    one library build makes of the source binds both."""
    with open(os.path.join(build.CSRC, f"{name}.cu")) as fh:
        src = fh.read()
    symbol = build.ROUTE_POINTS[name, route][0]
    for x in (symbol, f"{symbol}_grid"):
        assert re.search(rf'extern "C" int {x}\(', src), x


def _c_function(src, name):
    """The body of the C or CUDA function `name` defined in src: from its
    name to the first closing brace at the start of a line."""
    at = re.search(rf"\b{name}\(", src)
    assert at, name
    return src[at.start():src.index("\n}\n", at.start())]


def _floor_of():
    """chip_smoke.FLOOR_OF, read from the script's source (importing it
    needs no card, but its literal is all this needs)."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as fh:
        tree = ast.parse(fh.read())
    return next(ast.literal_eval(node.value) for node in tree.body
                if isinstance(node, ast.Assign) and
                [ast.unparse(t) for t in node.targets] == ["FLOOR_OF"])


@pytest.mark.parametrize("name, route", sorted(kernels.ROUTES))
def test_on_chip_walk_goes_with_entry_zeroing_and_a_floor_split(name,
                                                               route):
    """For every (kernel, route): its C entry point launches, through
    VTW_LAUNCH_TILE, a kernel that calls walk_tile (the on-chip walk);
    the entry point zeroes the outputs with cudaMemsetAsync before the
    launch; the route's wrapper allocates them with torch.empty and
    runs no fill op (which timing.device_ms would not time); and
    chip_smoke.py's FLOOR_OF splits its floor."""
    with open(os.path.join(build.CSRC, f"{name}.cu")) as fh:
        src = fh.read()
    symbol = build.ROUTE_POINTS.get((name, route),
                                    build.ENTRY_POINTS[name])[0]
    entry = _c_function(src, symbol)
    launch = re.search(r"VTW_LAUNCH_TILE\(\s*lanes,\s*\w+,\s*"
                       r"(\w+_kernel),", entry)
    assert launch, symbol
    assert "walk_tile(" in _c_function(src, launch.group(1))
    assert -1 < entry.find("cudaMemsetAsync(") < launch.start()
    wrapper = inspect.getsource(getattr(kernels, kernels.ROUTES[name,
                                                                route]))
    assert "torch.empty(" in wrapper
    assert not re.search(r"zeros|\.zero_\(|\.fill_\(|\bfull", wrapper)
    assert (name, route) in _floor_of()


# the strip walk's pieces, which the on-chip walk replaced
STRIP_WALK = (r"\bplan\(", r"\bstage\(", r"\brare_group\b", r"\bwalk\(",
              r"\bgrid_info\(", r"\bVTW_LAUNCH_BY_LANES\b",
              r"\bMIN_BLOCKS\b", r"\bSPAN\b")


@pytest.mark.parametrize("source", sorted(
    x for x in os.listdir(build.CSRC) if x.endswith((".cu", ".cuh"))))
def test_no_source_holds_the_strip_walk(source):
    """walk.cuh and every kernel source in csrc/ neither define nor call
    (nor name in a comment) the strip walk's plan, stage, rare_group,
    walk, grid_info, VTW_LAUNCH_BY_LANES, MIN_BLOCKS or SPAN: every
    kernel runs the on-chip walk, through plan_tile, stage_tile,
    rare_tile, walk_tile, grid_info_tile and VTW_LAUNCH_TILE."""
    with open(os.path.join(build.CSRC, source)) as fh:
        src = fh.read()
    assert [x for x in STRIP_WALK if re.search(x, src)] == []


def test_csrc_has_one_walk_header():
    """walk.cuh is the only header in csrc/, and every kernel has a grid
    query."""
    assert [x for x in os.listdir(build.CSRC) if x.endswith(".cuh")] == \
        ["walk.cuh"]
    assert set(build.GRID_POINTS) == set(build.ENTRY_POINTS)


def _walk_constant(name):
    with open(os.path.join(build.CSRC, "walk.cuh")) as fh:
        hit = re.search(rf"constexpr unsigned {name} = (0x[0-9A-F]+)u;",
                        fh.read())
    return int(hit.group(1), 16)


def _lane0(seqs, k, pad):
    return kernels.pack_codes(torch.as_tensor(seqs), k,
                              pad)[:, 0].numpy().view(np.uint32)


@pytest.mark.parametrize("k", [10, 20, 30, 40])
def test_walk_sentinels_are_the_pad_words(k):
    """ROW_SENTINEL is lane 0 of a hap window wholly in HAP_PAD and
    COL_SENTINEL that of a read window wholly in READ_PAD."""
    assert _lane0(np.full((1, 64), HAP_PAD, np.uint8), k, HAP_PAD)[0, 0] \
        == _walk_constant("ROW_SENTINEL")
    assert _lane0(np.full((1, 64), READ_PAD, np.uint8), k, READ_PAD)[0, 0] \
        == _walk_constant("COL_SENTINEL")


def test_no_code_holds_the_other_sides_sentinel():
    """Lane 0 packs 8 symbols, so a sentinel word needs 8 pad symbols.
    A hap holds HAP_PAD symbols only past its end and never READ_PAD's;
    an eligible read window (j <= rlen - k) holds only symbols of read
    bytes, forward or complemented, never HAP_PAD's.  Shown for every
    byte the CLI paths produce (key_modify's alphabet, X, x and =), then
    on packed codes of random rows."""
    alphabet = np.frombuffer(b"ACGTNacgtnXx=", np.uint8)
    nib = NIB_LUT
    hap_pad, read_pad = nib[HAP_PAD], nib[READ_PAD]
    assert hap_pad != read_pad
    assert not np.isin(nib[alphabet], [hap_pad, read_pad]).any()
    assert not np.isin(nib[oracle._COMP_LUT[alphabet]], [hap_pad]).any()

    rng = np.random.default_rng(3)
    H = R = 512
    haps = np.full((4, H), HAP_PAD, np.uint8)
    reads = np.full((4, R), READ_PAD, np.uint8)
    rlens = np.array([R - 40, R - 7, 100, 13], np.int32)
    for b in range(4):
        haps[b, :H - 30] = alphabet[rng.integers(0, alphabet.size, H - 30)]
        reads[b, :rlens[b]] = alphabet[rng.integers(0, alphabet.size,
                                                    rlens[b])]
    row_sentinel = _walk_constant("ROW_SENTINEL")
    col_sentinel = _walk_constant("COL_SENTINEL")
    for k in (10, 20, 30, 40):
        ch, cf, cd = fused.row_codes(torch.as_tensor(haps),
                                     torch.as_tensor(reads),
                                     torch.as_tensor(rlens), k)
        assert not (ch[:, 0].numpy().view(np.uint32) == col_sentinel).any()
        ok = np.arange(R)[None, :] <= (rlens - k)[:, None]
        for codes in (cf, cd):
            lane0 = codes[:, 0].numpy().view(np.uint32)
            assert not (lane0[ok] == row_sentinel).any()
