"""A run with the timed path broken underneath comes out as not correct:
an answer altered where the engine produces it, and half of each
event's reads left out.
The harness's look for a card is skipped: the runs are on the CPU."""
import pytest

from .conftest import BED, run_tiny


def _alter(pairs):
    """The first evaluable (read, haplotype) answer of a batch, changed."""
    out = [list(p) for p in pairs]
    for p in out:
        if 0 not in p:
            p[1] = p[1] * 1.5 + 1
            break
    return out


def _altered_answer(monkeypatch):
    from vapor_tpu_torch.engine.fused import FusedBackend
    from vapor_tpu_torch.validators import ValidatorContext
    score, score_del = ValidatorContext._score_async, \
        FusedBackend.score_del_batch_async

    def altered(self, *a, **kw):
        fin = score(self, *a, **kw)
        return lambda: _alter(fin())

    def altered_del(self, *a, **kw):
        fin = score_del(self, *a, **kw)

        def result():
            m1b, w10 = fin()
            return _alter(m1b), w10
        return result
    monkeypatch.setattr(ValidatorContext, "_score_async", altered)
    monkeypatch.setattr(FusedBackend, "score_del_batch_async", altered_del)


def _half_the_reads(monkeypatch):
    from vapor_tpu_torch import validators
    real = validators.collect_event_reads
    monkeypatch.setattr(validators, "collect_event_reads",
                        lambda *a, **kw: real(*a, **kw)[::2])


@pytest.mark.parametrize("name,fault", [
    ("hg002_tier1.clr30x", _altered_answer),
    ("hg002_tier1.clr30x", _half_the_reads),
    (BED, _altered_answer),
    (BED, _half_the_reads),
])
def test_fault_is_not_correct(tiny, monkeypatch, name, fault):
    load, _ = tiny
    cell = load(name)
    fault(monkeypatch)
    result = run_tiny(cell, seed=23)
    assert not result["correct"], result["check"]
