"""Benchmark run protocol and metrics persistence.

Counterpart of ``stencilstream_tpu/bench/harness.py``, the port of the
per-example ``benchmark.jl`` scripts
(``examples/hotspot/scripts/benchmark.jl:22-90``): a warm-up run, N timed
samples, the minimum walltime, the result written to
``metrics.<variant>.json``. A sample is timed on the host clock around a
call that ends once the card is done (a blocking updater synchronizes every
device it ran on). The warm-up takes the first call's set-up, which on a
fresh checkout includes building the CUDA library with ``nvcc``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable

import torch

from .model import GpuSpec, model_report

__all__ = [
    "BenchmarkResult",
    "run_benchmark",
    "write_metrics",
    "model_inputs",
]


def model_inputs(tf, grid, backend, n_iterations, wall, flops_per_cell, updater, spec=None):
    """The configuration that ran, for the model: its ``iters_per_pass``,
    the HBM bytes a pass moves (as ``halo_overhead``, exact, negative where
    invariant fields are read and not written) and the cells it computes
    (as ``compute_overhead``), from :func:`.profile.kernel_stats`. Returns
    ``(model_kwargs, kernel_stats)``; the stats are None for ``reference``,
    whose model counts the operations and one read and write a cell and
    iteration.

    ``updater`` is the one that ran (after at least one call): its
    resolved configuration is what is modeled, ``auto``'s choice, the line
    cache's and the tile pass's geometry, the mesh's shards. ``monotile``
    keeps none, so its plan is computed again as the backend computes it.
    """
    from ..backends import monotile
    from ..backends.cuda_lib import cell_field_bytes, cell_smem_bytes, device_limits, tile_reach
    from ..backends.line_cache import run_rows
    from ..core.cell import cell_leaves
    from .profile import kernel_stats

    if backend == "auto":
        backend = updater.resolved_backend
    config = getattr(updater, "resolved_config", None)
    dtype = "float64" if any(t.dtype == torch.float64 for t in cell_leaves(grid.arrays)) else "float32"
    if backend == "reference":
        return dict(dtype=dtype), None
    H, W = grid.shape
    if backend == "monotile":
        plan = monotile.require_plan(H, W, tf, cell_smem_bytes(grid.arrays, tf), device_limits(grid.device))
        config = dict(band=plan.band, q=plan.q, n_ctas=plan.n_ctas, threads=plan.threads)
    variant, invariant = cell_field_bytes(grid.arrays, tf)
    stats = kernel_stats(
        (H, W), variant, invariant,
        radius=tf.stencil_radius, n_subiterations=tf.n_subiterations, n_iterations=n_iterations,
        config=config, run=run_rows(grid.arrays, tf), measured_walltime=wall,
        flops_per_cell=flops_per_cell, spec=spec, dtype=dtype, reach=tile_reach(tf),
    )
    stats["backend"] = backend
    cells = H * W
    cell_bytes = sum(t.element_size() for t in cell_leaves(grid.arrays))
    per_pass = stats["per_pass"]
    p = n_iterations if backend == "monotile" else config["iters_per_pass"]
    mk = dict(
        iters_per_pass=p,
        halo_overhead=(per_pass["hbm_read_bytes"] + per_pass["hbm_write_bytes"]) / (cells * cell_bytes) - 2.0,
        compute_overhead=per_pass["redundancy"] - 1.0,
        dtype=dtype,
    )
    return mk, stats


@dataclasses.dataclass
class BenchmarkResult:
    """The analog of the reference's ``BenchmarkInformation`` record
    (``scripts/benchmark-common.jl:50-73``)."""

    variant: str
    grid_shape: tuple[int, int]
    n_iterations: int
    cell_bytes: int
    flops_per_cell: float
    walltime_s: float
    samples_s: list[float]
    cells_per_s: float
    gflops: float
    model: dict
    #: :func:`.profile.kernel_stats` of the configuration that ran (None for
    #: ``reference``).
    kernel: dict | None = None
    #: Case-specific top-level fields (convection's ``with_err`` and
    #: ``folded`` kernel-variant flags, which ``tables.render_rows`` reads).
    extra: dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["grid_shape"] = list(self.grid_shape)
        if d.get("kernel") is None:
            d.pop("kernel", None)
        d.update(d.pop("extra", {}))
        return d


def run_benchmark(
    run_once: Callable[[], Any],
    *,
    variant: str,
    grid_shape: tuple[int, int],
    n_iterations: int,
    cell_bytes: int,
    flops_per_cell: float = 0.0,
    n_samples: int = 3,
    warmup: bool = True,
    spec: GpuSpec | None = None,
    model_kwargs: dict | None = None,
) -> BenchmarkResult:
    """A warm-up and ``n_samples`` timed runs of ``run_once`` (which must
    return once the card is done: a blocking updater's call); the minimum
    wins, as in the reference's protocol. Without the warm-up the first
    sample includes the first call's set-up, the CUDA library's build on a
    fresh checkout among it, and the result says so (``extra``)."""
    if warmup:
        run_once()
    samples = []
    for _ in range(n_samples):
        t0 = time.perf_counter()
        run_once()
        samples.append(time.perf_counter() - t0)
    wall = min(samples)
    cells = grid_shape[0] * grid_shape[1]
    spec = spec or GpuSpec.detect()
    result = BenchmarkResult(
        variant=variant,
        grid_shape=grid_shape,
        n_iterations=n_iterations,
        cell_bytes=cell_bytes,
        flops_per_cell=flops_per_cell,
        walltime_s=wall,
        samples_s=samples,
        cells_per_s=cells * n_iterations / wall,
        gflops=cells * n_iterations * flops_per_cell / wall / 1e9,
        model=model_report(spec, cells, n_iterations, cell_bytes, wall, flops_per_cell=flops_per_cell,
                           **(model_kwargs or {})),
    )
    if not warmup:
        result.extra["first_sample"] = "includes the first call's set-up (the CUDA library's build if not built)"
    return result


def write_metrics(result: BenchmarkResult, directory: str = ".", card: str | None = None) -> str:
    """Persist as ``metrics.<variant>.json`` (the reference's output file
    contract, ``examples/hotspot/scripts/benchmark.jl`` tail), with a
    ``recorded_utc`` stamp and the ``card`` the numbers come from: its name
    and power limit as ``nvidia-smi`` gives them, or ``"cpu: plain
    versions, host clock"`` (default: CUDA device 0's when there is one, the
    CPU's otherwise). No number leaves the bench without the card beside
    it."""
    from ..experiments.common import card_line

    if card is None:
        card = card_line(torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu"))
    d = result.to_json()
    d["recorded_utc"] = time.strftime("%Y-%m-%d %H:%M:%SZ", time.gmtime())
    d["card"] = card
    path = os.path.join(directory, f"metrics.{result.variant}.json")
    with open(path, "w") as f:
        json.dump(d, f, indent=2)
    return path
