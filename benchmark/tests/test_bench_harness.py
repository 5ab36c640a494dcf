"""The harness finds cells, configurations, drivers and metric readers by
name, and takes a new cell or metric from new files alone."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests._drive import ROOT

BENCH = json.loads(open(os.path.join(ROOT, "BENCHMARK.json")).read())
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    spec = harness.Spec(ROOT, cell)
    assert spec.wl["config"] == spec.entry["config"]
    assert spec.wl["traffic"] == spec.entry["traffic"] and spec.wl["why"] == spec.entry["why"]
    assert spec.cfg["name"] == spec.entry["config"]
    assert hasattr(spec.load("drivers", spec.wl["driver"]), "Driver")
    for trace in (0, 1):
        names = [m["name"] for m in spec.metrics(trace)]
        assert names, f"{cell} reports no metric with trace={trace}"
    e2e = [m["name"] for m in spec.metrics(0)]
    assert "setup_s" in e2e and len(e2e) >= 2


@pytest.mark.parametrize("name", METRICS)
def test_metric_reader_found_by_name(name):
    spec = harness.Spec(ROOT, CELLS[0])
    assert callable(spec.load("metrics", name).read)


def test_per_layer_metrics_move_a_reported_metric():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", CELLS), (m["name"], cell)


def _digests(root):
    out = {}
    for base, _, files in os.walk(os.path.join(root, "benchmark")):
        for name in files:
            if name.endswith((".py", ".json")):
                path = os.path.join(base, name)
                out[os.path.relpath(path, root)] = hashlib.sha256(open(path, "rb").read()).hexdigest()
    return out


def test_new_cell_and_metric_take_new_files_only(tmp_path):
    """A cell of an existing configuration under new traffic, and a new
    per-layer metric: new files and new entries in BENCHMARK.json, no edit
    of a file the benchmark has."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = _digests(str(tmp_path))
    bench = dict(BENCH)
    wl = json.loads(open(os.path.join(ROOT, "benchmark/workloads/camel2d.integrate.json")).read())
    wl.update(traffic="integrate_small", neval=1 << 16, why="a smaller integrate call")
    (tmp_path / "benchmark/workloads/camel2d.integrate_small.json").write_text(json.dumps(wl))
    (tmp_path / "benchmark/metrics/calls_in_window.py").write_text(
        "def read(run):\n    return len(run.calls)\n")
    bench["workloads"] = BENCH["workloads"] + [
        {"name": "camel2d.integrate_small", "config": "camel2d", "traffic": "integrate_small",
         "chips": 1, "why": wl["why"]}]
    bench["per_layer"] = BENCH["per_layer"] + [
        {"name": "calls_in_window", "unit": "calls", "better": "higher", "source": "host_clock",
         "layer": "entry points", "moves": "samples_per_s", "workloads": ["camel2d.integrate_small"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    spec = harness.Spec(str(tmp_path), "camel2d.integrate_small")
    assert spec.wl["neval"] == 1 << 16
    assert [m["name"] for m in spec.metrics(1)] == ["calls_in_window"]
    ctx = harness.Ctx(spec, 1, "cpu")
    run = harness.Run(spec, ctx, None, 1.0, 0.0, [{"t0": 0, "t1": 1, "samples": 5}] * 3)
    assert spec.load("metrics", "calls_in_window").read(run) == 3
    after = _digests(str(tmp_path))
    assert {k: v for k, v in after.items() if k in before} == before


def test_run_refuses_without_a_card(tmp_path):
    """No card: a code other than 0 and no result line; so, too, in a
    directory that holds only BENCHMARK.json and the benchmark's files."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    for cwd in (ROOT, str(tmp_path)):
        out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0],
                              "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
                             cwd=cwd, env=env, capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert "correct" not in out.stdout


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(cell, card):
    """A short traced run of each cell (12 s: a whole training call fits):
    correct, every metric the cell names, the device's busy time, a
    breakdown."""
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell,
                          "--seed", "3000000123", "--seconds", "12", "--trace", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], (result["checks"], out.stderr[-3000:])
    spec = harness.Spec(ROOT, cell)
    assert set(result["metrics"]) == {m["name"] for m in spec.metrics(1)}
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert result["breakdown"]["device_ops"] and list(result)[-1] == "checks"
