"""Where the benchmark finds a cell's parts: by name, from files.

``BENCHMARK.json`` at the root of the checkout names the cells, their
configuration and traffic, and the metrics. Each name leads to a file
under ``benchmark/``:

* ``configs/<config>.json``: the configuration as it is run (sizes, dtype,
  the work counts of the roofline, the guarantees);
* ``apps/<config>.py``: the inputs made from the seed and the port's updater;
* ``reference/<config>.py``: the plain PyTorch reference;
* ``traffic/<traffic>.json``: grid, iterations a call, backend and options,
  calls a simulation runs before it starts again;
* ``workloads/<cell>.json``: the limits of the cell's comparison;
* ``metrics/<metric>.py``: one reader a metric, ``read(record)``.

A later cell, configuration or metric is new files and new entries here;
no file that exists changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType

__all__ = ["ROOT", "Spec", "load_module"]

#: The root of the checkout: the directory that holds ``BENCHMARK.json``.
ROOT = Path(__file__).resolve().parent.parent


def load_module(path: Path) -> ModuleType:
    """Import one file by its path (metric files carry dots in their
    names, so they are no package's modules)."""
    name = "ssbench_" + "_".join(path.relative_to(path.parents[1]).with_suffix("").parts).replace(".", "_")
    module_spec = importlib.util.spec_from_file_location(name, path)
    if module_spec is None or module_spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module


class Spec:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.bench = self.root / "benchmark"
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def _json(self, kind: str, name: str) -> dict:
        return json.loads((self.bench / kind / f"{name}.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def limits(self, cell: str) -> dict:
        return self._json("workloads", cell)["limits"]

    def peaks(self) -> list:
        return json.loads((self.bench / "peaks.json").read_text())["devices"]

    def app(self, config: str) -> ModuleType:
        return load_module(self.bench / "apps" / f"{config}.py")

    def reference(self, config: str) -> ModuleType:
        return load_module(self.bench / "reference" / f"{config}.py")

    def metrics(self, traced: bool) -> list[dict]:
        """The metrics a run reads: the end-to-end ones with ``traced``
        false, the per-layer ones with it true. A reader that finds nothing
        to read in a cell returns ``None``."""
        return self.data["per_layer" if traced else "end_to_end"]

    def reader(self, metric: str):
        """The ``read(record)`` function of a metric."""
        return load_module(self.bench / "metrics" / f"{metric}.py").read
