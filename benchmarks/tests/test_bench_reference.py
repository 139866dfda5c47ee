"""The plain reference agrees with the program's CLI on the CPU, imports
nothing of the program, and its control comes out as not correct."""
import subprocess
import sys

import pytest

from benchmarks import check, gen

from .conftest import BED, REPO, run_tiny


@pytest.mark.parametrize("name", ["hg002_tier1.clr30x", BED])
def test_reference_agrees_with_the_cli(tiny, name):
    load, _ = tiny
    result = run_tiny(load(name), seed=2**31 + 17)
    assert result["correct"], result["check"]
    assert result["check"]["rows_wrong"]["value"] == 0
    assert result["attempted"] > 0 and result["failed"] == 0


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import benchmarks.check, benchmarks.gen, "
            "benchmarks.reference.vapor; print(sorted({m.split('.')[0] "
            "for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True).stdout
    loaded = set(eval(out))
    assert not loaded & {"jax", "jaxlib", "flax", "vapor_tpu",
                         "vapor_tpu_torch", "torch"}


@pytest.mark.parametrize("name", ["hg002_tier1.clr30x", BED])
def test_control_is_not_correct(tiny, tmp_path, name):
    load, _ = tiny
    cell = load(name)
    inputs = gen.build(str(tmp_path / "d"), cell.config, cell.traffic, 5)
    numbers, _ = check.control(cell, inputs, 5)
    assert not check.passed(numbers), numbers
    assert numbers["rows_wrong"]["value"] > numbers["rows_wrong"]["limit"]
    assert numbers["rows_missing_or_extra"]["value"] == 0
