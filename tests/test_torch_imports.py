"""vapor_tpu_torch stands alone: no file of it, nor chip_smoke.py, nor
the port's scripts (scripts/*_torch.py, scripts/profile_torch_bed.py),
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
    yield os.path.join(ROOT, "scripts", "profile_torch_bed.py")
    for f in sorted(os.listdir(os.path.join(ROOT, "scripts"))):
        if f.endswith("_torch.py"):
            yield os.path.join(ROOT, "scripts", f)
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
    names = {os.path.relpath(p, ROOT) for p in files}
    assert {"vapor_tpu_torch/engine/batching.py",
            "vapor_tpu_torch/engine/window_device.py",
            "vapor_tpu_torch/orchestrate.py", "vapor_tpu_torch/io/tabix.py",
            "vapor_tpu_torch/native/__init__.py",
            "vapor_tpu_torch/parallel/mesh.py",
            "vapor_tpu_torch/parallel/multihost.py",
            "vapor_tpu_torch/utils/trace.py",
            "vapor_tpu_torch/sim/synth.py", "vapor_tpu_torch/sim/truthset.py",
            "vapor_tpu_torch/sim/scale.py", "vapor_tpu_torch/sim/corpus.py",
            "vapor_tpu_torch/sim/worklists.py",
            "scripts/profile_torch_bed.py",
            "scripts/accuracy_corpus_torch.py",
            "scripts/measure_refiner_band_torch.py",
            "scripts/capstone_scale_torch.py",
            "vapor_tpu_torch/sim/goldens.py",
            "vapor_tpu_torch/engine/kernels/roofline.py",
            "vapor_tpu_torch/engine/kernels/timing.py",
            "scripts/cli_parity_torch.py",
            "scripts/e2e_pipeline_bench_torch.py",
            "scripts/scale_run_torch.py",
            "scripts/scaling_sim_torch.py",
            "scripts/scaling_curve_torch.py",
            "scripts/profile_engine_torch.py",
            "scripts/profile_e2e_torch.py",
            "vapor_tpu_torch/engine/kernel.py",
            "vapor_tpu_torch/engine/legacy.py",
            "vapor_tpu_torch/grammar/classify.py",
            "vapor_tpu_torch/prep.py"} <= names
    bad = [(os.path.relpath(p, ROOT), name) for p in files
           for name in _imported(p)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad


def test_import_loads_neither():
    code = ("import sys, vapor_tpu_torch.cli, "
            "vapor_tpu_torch.engine.fused, vapor_tpu_torch.sim.scale, "
            "vapor_tpu_torch.sim.synth, vapor_tpu_torch.sim.truthset, "
            "vapor_tpu_torch.sim.corpus, vapor_tpu_torch.sim.worklists, "
            "vapor_tpu_torch.sim.goldens, "
            "vapor_tpu_torch.engine.kernels.roofline, "
            "vapor_tpu_torch.engine.kernels.timing, "
            "vapor_tpu_torch.engine.batching, "
            "vapor_tpu_torch.engine.window_device, "
            "vapor_tpu_torch.orchestrate, vapor_tpu_torch.io.tabix, "
            "vapor_tpu_torch.native, vapor_tpu_torch.parallel.mesh, "
            "vapor_tpu_torch.parallel.multihost, "
            "vapor_tpu_torch.utils.trace, vapor_tpu_torch.engine.kernel, "
            "vapor_tpu_torch.engine.legacy, vapor_tpu_torch.grammar.classify, "
            "vapor_tpu_torch.prep; "
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
    for name in ("torch", "torch-nobatch", "torch-v1"):
        with pytest.raises(RuntimeError, match="CUDA"):
            get_backend(name)
