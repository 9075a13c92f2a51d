"""The benchmark's own tests: ``python -m pytest benchmark/tests``.

They run on the CPU through the port's plain versions; those marked
``gpu`` need a CUDA card and skip without one (``python -m pytest -m gpu
benchmark/tests`` on the card).
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def cuda():
    """Skip unless a CUDA card is there (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


#: Small cells for the CPU, added beside the real ones in a copy of the
#: benchmark: HotSpot on 4096 rows keeps the row spacing, and so the
#: vertical coupling a call sees, of a 4096-row chip.
TEST_TRAFFIC = {
    "test-hot": ("hotspot", {"height": 4096, "width": 16, "n_iterations": 50, "backend": "tiling",
                             "options": {}, "calls_per_run": 0}),
    "test-jac": ("jacobi5", {"height": 40, "width": 72, "n_iterations": 6, "backend": "auto",
                             "options": {}, "calls_per_run": 3}),
}
TEST_LIMITS = {"chain_err": 1e-4, "sample_err": 1e-4}


def add_cell(root: Path, name: str, config: str, traffic: dict, limits: dict = TEST_LIMITS) -> None:
    """A cell, its traffic and its limits, as new files and a new entry."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": name, "config": config, "traffic": name, "chips": 1, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "benchmark" / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
    (root / "benchmark" / "workloads" / f"{name}.json").write_text(json.dumps({"limits": limits}))


@pytest.fixture
def test_root(tmp_path):
    """A copy of ``BENCHMARK.json`` and ``benchmark/`` with the small cells."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, (config, traffic) in TEST_TRAFFIC.items():
        add_cell(tmp_path, name, config, traffic)
    return tmp_path
