"""vapor_tpu_torch stands alone: no file of it, nor chip_smoke.py,
imports jax or vapor_tpu, and importing it loads neither."""
import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "vapor_tpu")


def _port_files():
    yield os.path.join(ROOT, "chip_smoke.py")
    for base, _, files in os.walk(os.path.join(ROOT, "vapor_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def _imported(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_file_imports_jax_or_vapor_tpu():
    files = list(_port_files())
    assert len(files) > 20
    bad = [(os.path.relpath(p, ROOT), name) for p in files
           for name in _imported(p)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad


def test_import_loads_neither():
    code = ("import sys, vapor_tpu_torch.cli, "
            "vapor_tpu_torch.engine.fused, vapor_tpu_torch.sim.scale; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'vapor_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.strip()
    assert out == "[]"


def test_torch_backend_without_card_raises():
    from vapor_tpu_torch.engine.scoring import get_backend
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        get_backend("torch")
