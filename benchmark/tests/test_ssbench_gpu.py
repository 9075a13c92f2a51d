"""On the card: one short run of each cell's kind, through the benchmark's
own command (``python -m pytest -m gpu benchmark/tests``)."""

import json
import subprocess
import sys

import pytest

from benchmark.spec import ROOT


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
def test_short_run_on_the_card(cuda, trace):
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "hotspot-1024", "--seed",
                           "2147483659", "--seconds", "2", "--trace", str(trace)],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["platform"] == "gpu"
    assert result["device"]["memory_peak_bytes"] > 0
