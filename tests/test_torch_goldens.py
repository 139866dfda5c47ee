"""vapor_tpu_torch.sim.goldens against tests/golden_cases.py: for every
golden of fixtures/golden/, the port's builder writes the same files byte
for byte (FASTA, .fai, BAM, .bai where written, and the BED, VCF,
svelter or MELT inputs), and its runners reproduce the goldens."""
import os

import pytest

import golden_cases as gc
from vapor_tpu_torch.sim import goldens


def _tree(d):
    """{relative path: bytes} of every file under d."""
    out = {}
    for base, _, files in os.walk(d):
        for f in files:
            path = os.path.join(base, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, d)] = fh.read()
    return out


# the JAX package's builder of each golden's case
JAX_BUILDERS = {
    **{f"bed_{t.lower()}_{seed}":
       (lambda d, c=(t, s0, e0, seed, het): gc.build_bed_case(d, *c))
       for t, s0, e0, seed, het in gc.BED_CASES},
    "vcf_all_types": gc.build_vcf_case,
    "vcf_all_types_annotated": gc.build_vcf_case,
    "bed_junction_big": gc.build_big_case,
    "vcf_fallbacks": gc.build_fb_case,
    "svelter_basic": gc.build_svelter_case,
    "ins_melt": gc.build_melt_case,
}


def test_same_cases_and_golden_dir():
    assert set(goldens.BUILDERS) == set(gc.GOLDEN_CASES) == \
        set(goldens.RUNNERS) == set(JAX_BUILDERS)
    assert os.path.samefile(goldens.GOLDEN_DIR, gc.GOLDEN_DIR)
    assert goldens.BED_CASES == gc.BED_CASES


@pytest.mark.parametrize("name", sorted(gc.GOLDEN_CASES))
def test_builder_writes_the_same_bytes(name, tmp_path):
    a, b = tmp_path / "jax", tmp_path / "torch"
    a.mkdir()
    b.mkdir()
    want_case = JAX_BUILDERS[name](str(a))
    got_case = goldens.BUILDERS[name](str(b))
    want, got = _tree(str(a)), _tree(str(b))
    assert sorted(got) == sorted(want)
    assert {"ref.fa", "ref.fa.fai", "reads.bam"} <= set(got)
    for path in want:
        assert got[path] == want[path], path
    # the case dicts name the same files, relative to their directory
    assert {k: os.path.relpath(v, str(b)) for k, v in got_case.items()} == \
        {k: os.path.relpath(v, str(a)) for k, v in want_case.items()}
