"""Benchmark and measurement tooling of the port.

Counterpart of ``stencilstream_tpu/bench/``, the port of the reference's
Julia harness (SURVEY.md §2.10), on an NVIDIA card:

* :mod:`.harness`: the run protocol (warm-up, N samples, minimum
  walltime) and ``metrics.<variant>.json`` with the card beside every
  number (``examples/hotspot/scripts/benchmark.jl:22-90``);
* :mod:`.model`: the analytic model (``scripts/benchmark-common.jl:75-173``)
  as a bound on an H100: HBM roofline, temporal blocking, the transition
  function's operations at the card's float peak, the share of the bound a
  run reaches; the port's one table of the card's peaks;
* :mod:`.profile`: ``torch.profiler`` traces and the kernels' exact bytes,
  cells and launches a pass;
* :mod:`.curves` and :mod:`.tables`: throughput-vs-size and summary tables
  rendered from the recorded files;
* ``python -m stencilstream_tpu_torch.bench``: the ``max_perf``,
  ``grid_scaling`` and ``strong_scaling`` CLI.
"""

from .harness import BenchmarkResult, run_benchmark, write_metrics
from .model import GpuSpec, model_report, predicted_runtime, roofline_cells_per_s

__all__ = [
    "BenchmarkResult",
    "run_benchmark",
    "write_metrics",
    "GpuSpec",
    "roofline_cells_per_s",
    "predicted_runtime",
    "model_report",
]
