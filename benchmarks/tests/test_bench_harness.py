"""The harness: driven by data, guarded, and fair to every call."""
import gc
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
    assert m["events_per_s_traced"]["value"] > 0
    assert dict(vars(ValidatorContext)) == before


def test_every_per_layer_metric_moves_an_end_to_end_metric_of_its_cells():
    """A per-layer metric names in `moves` an end-to-end metric that each
    of its cells reports; events/s, steady in no cell, is per layer."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    cells = [w["name"] for w in spec["workloads"]]
    e2e = {m["name"]: m.get("workloads", cells) for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        for cell in m.get("workloads", cells):
            assert cell in e2e[m["moves"]], (m["name"], cell)
    assert "events_per_s" not in e2e
    assert "events_per_s_traced" in {m["name"] for m in spec["per_layer"]}


def test_every_metric_of_the_vcf_cell_is_read_in_the_bed_cell():
    """Each per-layer metric that lists hg002_tier1.clr30x lists
    na12878_1kgp.clr30x too: the read-gather split, the launch, wait and
    self-time spans, the kernels and the device's idle share all have
    something to read in a bed-mode traced run."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    listed = [m for m in spec["per_layer"]
              if "hg002_tier1.clr30x" in m["workloads"]]
    assert len(listed) == 24
    for m in listed:
        assert m["workloads"] == ["hg002_tier1.clr30x",
                                  "na12878_1kgp.clr30x"], m["name"]


def test_untraced_run_reports_the_end_to_end_metrics_alone(tiny):
    load, _ = tiny
    result = run_tiny(load("hg002_tier1.clr30x"))
    assert result["correct"]
    assert set(result["metrics"]) == {"peak_host_rss_mib", "setup_s"}


def test_traced_rate_reads_the_window():
    run = harness.Run(setup_s=1.0, window_s=2.0, events=10, calls=[],
                      rss_mib=1.0, trace=True)
    read = harness.load_reader(harness.BENCH, "events_per_s_traced")
    assert read(run) == 5.0
    run.window_s = 0.0
    assert read(run) is None


def test_host_lines_go_to_stderr_before_the_numbers_compared(tiny,
                                                             capsys):
    """A line a call of what the host did, and the calibration loop, on
    stderr; the result keeps its keys and the check's lines come last."""
    load, _ = tiny
    result = run_tiny(load("hg002_tier1.clr30x"), seconds=2.0)
    assert result["correct"]
    err = capsys.readouterr().err.rstrip().splitlines()
    calls = [line for line in err if line.startswith("call ")]
    assert calls
    for line in calls:
        words = line.split()
        keys = dict(zip(words[2::2], words[3::2]))
        assert {"events", "wall_s", "before_s", "cpu_s", "main_cpu_s",
                "nvcsw", "nivcsw", "majflt", "gc2_s", "gc2_n"} == set(keys)
        assert float(keys["wall_s"]) > 0 and int(keys["events"]) == 3
    host = [line for line in err if line.startswith("host: calibration")]
    assert len(host) == 1 and f"calls {len(calls)} " in host[0]
    assert float(host[0].split()[-1]) > 0          # the window's events/s
    assert err[-1].startswith("check calls_failed")
    assert set(result) == {"correct", "attempted", "failed", "metrics",
                           "device", "check", "gen_s"}


def test_gen2_timer_counts_full_collections_only():
    timer = harness.Gen2Timer()
    gc.callbacks.append(timer)
    try:
        gc.collect(0)
        gc.collect(1)
        assert timer.count == 0
        gc.collect()
        assert timer.count == 1 and timer.seconds > 0
    finally:
        gc.callbacks.remove(timer)
