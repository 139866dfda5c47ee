"""The harness: driven by data, guarded, and fair to every call."""
import json
import os
import shutil
import subprocess
import sys
import types

from benchmarks import harness

from .conftest import BED, BED_ENTRY, REPO, make_tiny, run_tiny


def test_new_config_traffic_and_metric_from_files_alone(tmp_path,
                                                        monkeypatch):
    spec_path = make_tiny(str(tmp_path / "root"))
    root = os.path.dirname(spec_path)
    bench = os.path.join(root, "benchmarks")
    with open(os.path.join(root, BED_ENTRY["file"])) as fh:
        cfg = json.load(fh)
    cfg.update(name="extra_config", types={"INV": 1.0}, layout_seed=5)
    with open(os.path.join(bench, "configs", "extra_config.json"),
              "w") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(bench, "traffic", "clr30x.json")) as fh:
        tr = json.load(fh)
    tr["depth"] = 4
    with open(os.path.join(bench, "traffic", "extra_mix.json"), "w") as fh:
        json.dump(tr, fh)
    with open(os.path.join(bench, "metrics", "calls_completed.py"),
              "w") as fh:
        fh.write("def read(run):\n    return float(len(run.calls))\n")
    with open(spec_path) as fh:
        spec = json.load(fh)
    spec["configs"].append({"name": "extra_config", "source": "x",
                            "file": "benchmarks/configs/extra_config.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "extra.cell", "config": "extra_config",
                              "traffic": "extra_mix", "chips": 1,
                              "why": "x"})
    spec["end_to_end"].append({"name": "calls_completed", "unit": "calls",
                               "better": "higher", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": ["extra.cell"]})
    with open(spec_path, "w") as fh:
        json.dump(spec, fh)
    monkeypatch.setenv("TMPDIR", str(tmp_path / "tmp"))
    cell = harness.load_cell("extra.cell", spec_path, bench)
    result = run_tiny(cell)
    assert result["correct"], result["check"]
    assert result["metrics"]["calls_completed"]["value"] >= 1
    assert "events_per_s" not in result["metrics"]
    assert "setup_s" in result["metrics"]


def test_no_two_calls_read_the_same_paths(tiny, monkeypatch):
    load, _ = tiny
    from vapor_tpu_torch import cli
    seen = []
    real = cli.main

    def spy(argv):
        seen.append(argv)
        return real(argv)
    monkeypatch.setattr(cli, "main", spy)
    result = run_tiny(load("hg002_tier1.clr30x"), seconds=3.0)
    assert result["correct"]
    assert len(seen) >= 2            # the warm-up call and the window's
    for flag in ("--pacbio-input", "--reference", "--sv-input"):
        paths = [a[a.index(flag) + 1] for a in seen]
        assert len(set(paths)) == len(paths)
        tmp = os.environ["TMPDIR"]
        assert all(p.startswith(tmp) for p in paths)


def test_run_without_a_card_exits_nonzero_without_a_result():
    proc = subprocess.run(
        [sys.executable, "benchmarks/run.py", "--workload",
         "hg002_tier1.clr30x", "--seed", str(2**31 + 3), "--seconds", "1",
         "--trace", "0"], cwd=REPO, capture_output=True, text=True,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), timeout=300)
    assert proc.returncode != 0
    assert "{" not in proc.stdout


def test_run_beside_no_program_exits_nonzero(tmp_path):
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "benchmarks/run.py", "--workload",
         "hg002_tier1.clr30x", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, capture_output=True, text=True, env=env,
        timeout=300)
    assert proc.returncode != 0
    assert "{" not in proc.stdout


def test_forbidden_modules_compare_whole_names(monkeypatch):
    assert "vapor_tpu_torch" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "vapor_tpu", types.ModuleType("y"))
    assert harness.forbidden_modules() == ["jax", "vapor_tpu"]


def test_work_under_tmpdir(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    work = harness.work_root()
    assert work.startswith(str(tmp_path))


def test_traced_run_reads_spans_and_removes_them(tiny):
    load, _ = tiny
    from vapor_tpu_torch.validators import ValidatorContext
    before = dict(vars(ValidatorContext))
    result = run_tiny(load(BED), trace=True)
    assert result["correct"]
    m = result["metrics"]
    assert m["read_gather_ms_per_event"]["value"] > 0
    assert m["cli_self_ms_per_event"]["value"] > 0
    assert "events_per_s" not in m
    assert dict(vars(ValidatorContext)) == before
