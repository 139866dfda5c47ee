"""vapor_tpu_torch.grammar.classify and vapor_tpu_torch.prep against
vapor_tpu's: every public classifier gives vapor_tpu's result on
tests/test_classify.py's cases and on seeded random structures, and the
readme printers print vapor_tpu's text under the port's program name and
version."""
import random

import pytest

import vapor_tpu_torch
from vapor_tpu import prep as jprep
from vapor_tpu.grammar import classify as jc
from vapor_tpu_torch import prep as tprep
from vapor_tpu_torch.grammar import classify as tc
from test_classify import DIPLOID_CASES

HAPLOID = ("simple_del_haploid", "simple_inv_haploid",
           "simple_tandup_haploid", "simple_disdup_haploid")
DIPLOID = ("simple_del_decide", "simple_inv_decide", "simple_tandup_decide",
           "simple_disdup_decide")


def _outcome(fn, *args):
    """(result, None) or (None, exception type): some structures make
    the reference's classifiers raise, and the port must raise alike."""
    try:
        return fn(*args), None
    except Exception as exc:                # noqa: BLE001 - compared
        return None, type(exc)


def _same(name, *args):
    got = _outcome(getattr(tc, name), *args)
    assert got == _outcome(getattr(jc, name), *args), (name, args)
    return got


def _random_structures(seed, n):
    """(ref, alt) haploid structures: a deletion, an inversion, a tandem
    or dispersed duplication, or a mix of two, on 1-5 blocks."""
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        ref = "abcde"[: rng.randint(1, 5)]
        alt = list(ref)
        for _ in range(rng.randint(1, 2)):
            op = rng.choice(("del", "inv", "tandup", "disdup"))
            i = rng.randrange(len(alt)) if alt else 0
            j = rng.randint(i + 1, len(alt)) if alt else 0
            run = alt[i:j]
            if op == "del":
                alt = alt[:i] + alt[j:]
            elif op == "inv":
                alt = alt[:i] + [c.rstrip("^") + ("" if c.endswith("^")
                                                  else "^")
                                 for c in reversed(run)] + alt[j:]
            elif op == "tandup":
                alt = alt[:j] + run + alt[j:]
            else:
                k = rng.randint(0, len(alt))
                alt = alt[:k] + run + alt[k:]
        out.append((ref, "".join(alt)))
    return out


def test_public_functions_are_the_same_set():
    def public(mod):
        return {n for n, v in vars(mod).items()
                if callable(v) and not n.startswith("_") and
                getattr(v, "__module__", "") == mod.__name__}
    assert public(tc) == public(jc) == set(HAPLOID + DIPLOID +
                                           ("dup_block_combine",))


@pytest.mark.parametrize("name", DIPLOID)
def test_decide_on_the_reference_cases(name):
    for ref_s, alt_s in DIPLOID_CASES:
        _same(name, ref_s, alt_s)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_classifiers_on_random_structures(seed):
    decided = 0
    for ref, alt in _random_structures(seed, 120):
        for name in HAPLOID:
            got, exc = _same(name, ref, alt)
            decided += exc is None and got != "FALSE"
        for name in DIPLOID:
            _same(name, f"{ref}/{ref}", f"{alt}/{ref}")
            _same(name, f"{ref}/{ref}", f"{alt}/{alt}")
    assert decided >= 60


def test_dup_block_combine():
    for dup, ref_h, alt_h in [(["a", "b"], "abcd", "abab"),
                              (["a"], "ab", "aab"),
                              (["b", "c"], "abcd", "abcbcd"),
                              (["a", "c"], "abc", "acabc"),
                              (["a", "b", "c"], "abcd", "abcabcd")]:
        _same("dup_block_combine", dup, ref_h, alt_h)
    for ref, alt in _random_structures(9, 80):
        dup = sorted({c for c in alt if c != "^" and alt.count(c) > 1})
        _same("dup_block_combine", dup, ref, alt)


def _printed(capsys, fn):
    fn()
    return capsys.readouterr().out


def _as_port(text):
    """vapor_tpu's text under the port's version and program name."""
    return text.replace(jprep.vapor_version, tprep.vapor_version).replace(
        "Usage: vapor-tpu ", f"Usage: {tprep.PROG} ")


def test_prep_version():
    assert tprep.vapor_version == vapor_tpu_torch.vapor_version == \
        f"vapor-tpu-torch V{vapor_tpu_torch.__version__}"


def test_prep_printers_text(capsys):
    theirs = _printed(capsys, jprep.print_read_me)
    ours = _printed(capsys, tprep.print_read_me)
    assert ours == _as_port(theirs)
    assert ours.splitlines()[0] == tprep.vapor_version
    assert f"Usage: {tprep.PROG} [Options] [Parameters]" in ours
    assert set(tprep.READMES) == set(jprep.READMES)
    for mode in tprep.READMES:
        theirs = _printed(capsys, jprep.READMES[mode])
        ours = _printed(capsys, tprep.READMES[mode])
        assert ours == _as_port(theirs)
        assert f"Usage: {tprep.PROG} {mode} [Parameters]" in ours
        assert "--pacbio-input" in ours


def test_cli_version_flag_is_prep_version(capsys):
    from vapor_tpu_torch.cli import build_parser
    with pytest.raises(SystemExit) as exc:
        build_parser().parse_args(["--version"])
    assert exc.value.code == 0
    assert tprep.vapor_version in capsys.readouterr().out
