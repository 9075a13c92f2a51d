"""A run on the CPU through the port's plain versions: the result line,
discovery of a cell and a metric from their files alone, and the faults
and the control that must come out not correct."""

import json
import math
import os
import shutil
import subprocess
import sys
import types

import pytest
import torch

from benchmark import run as bench_run
from benchmark.check import rel_err
from benchmark.faults import FAULTS, control
from benchmark.run import run_cell
from benchmark.spec import ROOT, Spec

from conftest import add_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(root, cell, traced=False, wrap=None, seconds=0.3, seed=2**31 + 12345):
    return run_cell(Spec(root), cell, seed, seconds, traced, device="cpu", wrap=wrap)


@pytest.mark.parametrize("cell", ["test-hot", "test-jac"])
def test_result_line(test_root, cell):
    result = _run(test_root, cell)
    assert list(result)[:5] == KEYS and list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 2
    json.loads(json.dumps(result))
    # off the card there is no peak memory; every other end-to-end metric is there
    assert set(result["metrics"]) == {"gcell_per_s", "call_ms.p95", "setup_s"}
    assert all(v["value"] > 0 for v in result["metrics"].values())
    for name, check in result["checks"].items():
        assert 0 <= check["value"] <= check["limit"]


def test_traced_result_line(test_root):
    result = _run(test_root, "test-jac", traced=True, seconds=0.5)
    assert set(result["device"]) >= {"busy_s", "window_s"}
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in result["breakdown"].values())
    # the CPU traces no device and counts no launch: only the counter's metric is read
    assert set(result["metrics"]) == {"backends.launches_per_call"}


def test_a_cell_and_a_metric_from_their_files_alone(test_root):
    """A new cell, a new configuration and a new metric are new files and
    new entries; no existing file changes."""
    before = {p: p.read_bytes() for p in (test_root / "benchmark").rglob("*") if p.is_file()}
    bench = json.loads((test_root / "BENCHMARK.json").read_text())
    cfg = json.loads((test_root / "benchmark/configs/jacobi5.json").read_text())
    cfg["name"] = "jacobi5b"
    cfg["coefficients"] = {"up": 0.1, "left": 0.1, "down": 0.1, "right": 0.1, "center": 0.6}
    (test_root / "benchmark/configs/jacobi5b.json").write_text(json.dumps(cfg))
    for kind in ("apps", "reference"):
        shutil.copy(test_root / f"benchmark/{kind}/jacobi5.py", test_root / f"benchmark/{kind}/jacobi5b.py")
    bench["configs"].append({"name": "jacobi5b", "source": "https://example.org", "reduced": [],
                             "file": "benchmark/configs/jacobi5b.json", "why": "a test"})
    bench["end_to_end"].append({"name": "calls_done", "unit": "calls", "better": "higher", "bound": 0.05,
                                "source": "host_clock"})
    (test_root / "BENCHMARK.json").write_text(json.dumps(bench))
    (test_root / "benchmark/metrics/calls_done.py").write_text("def read(record):\n    return record['calls']\n")
    add_cell(test_root, "new-cell", "jacobi5b", {"height": 24, "width": 40, "n_iterations": 3,
                                                  "backend": "tiling", "options": {}, "calls_per_run": 0})
    result = _run(test_root, "new-cell")
    assert result["correct"] and result["metrics"]["calls_done"]["value"] == result["attempted"]
    assert set(_run(test_root, "test-jac")["metrics"]) == {"gcell_per_s", "call_ms.p95", "setup_s", "calls_done"}
    assert all(p.read_bytes() == b for p, b in before.items())


@pytest.mark.parametrize("cell", ["test-hot", "test-jac"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(test_root, cell, fault):
    result = _run(test_root, cell, wrap=FAULTS[fault])
    assert result["correct"] is False and result["failed"] >= 1


@pytest.mark.parametrize("cell", ["test-hot", "test-jac"])
def test_control_is_not_correct(test_root, cell):
    spec = Spec(test_root)
    w = spec.cell(cell)
    wrap = control(spec.reference(w["config"]), spec.config(w["config"]), spec.traffic(w["traffic"]))
    result = _run(test_root, cell, wrap=wrap, seconds=0.1)
    assert result["correct"] is False
    assert max(c["value"] for c in result["checks"].values()) > 10 * max(c["limit"] for c in result["checks"].values())


def test_the_cells_limits_fail_the_control():
    """At each cell's own limits, the control at a test size fails."""
    spec = Spec()
    for w in spec.data["workloads"]:
        cfg, ref, app = spec.config(w["config"]), spec.reference(w["config"]), spec.app(w["config"])
        side = (4096, 16) if w["config"] == "hotspot" else (40, 72)
        fields = app.make_inputs(*side, 77, "cpu")
        err = rel_err(ref.run(fields, 40, cfg, dtype=torch.bfloat16), ref.run(fields, 40, cfg))
        assert err > max(spec.limits(w["name"]).values())


def test_no_card_no_result(tmp_path):
    """Off the card, or in a checkout of the benchmark alone, a run exits
    with an error and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd in (ROOT, tmp_path):
        proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "hotspot-8192",
                               "--seed", "1", "--seconds", "1", "--trace", "0"],
                              cwd=cwd, capture_output=True, text=True, env=env, timeout=120)
        assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_nonfinite_output_reads_inf():
    assert math.isinf(rel_err({"v": torch.tensor([1.0, float("nan")])}, {"v": torch.tensor([1.0, 2.0])}))



def test_a_trace_that_misses_launches_is_refused(test_root, monkeypatch, capsys):
    """A launch counted that the profiler never saw: each traced segment is
    thrown away, another is tried, and the run raises instead of reporting."""
    counter = types.ModuleType("stencilstream_tpu_torch._counted")
    counter.launches = 0
    monkeypatch.setitem(sys.modules, counter.__name__, counter)
    monkeypatch.setattr(bench_run, "TRACE_SECONDS", 0.05)

    def wrap(update, app):
        def call(grid):
            counter.launches += 1
            return update(grid)

        return call

    with pytest.raises(RuntimeError, match="no complete trace"):
        _run(test_root, "test-jac", traced=True, wrap=wrap, seconds=4.0)
    err = capsys.readouterr().err
    assert all(f"traced segment {k}" in err for k in range(1, bench_run.TRACE_SEGMENTS + 1))
