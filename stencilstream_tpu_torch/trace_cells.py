"""Where the time goes in the port's main-path runs, on one NVIDIA card.

    python -m stencilstream_tpu_torch.trace_cells [--out trace.json] [--runs 1024,linecache]

Drives each main-path run (:func:`main_paths`, which ``chip_smoke.py``
drives too) through the entry point a user calls (HotSpot 1024² and
8192², Jacobi5 8192² in both tiling window modes, Jacobi5 1024², Conway
8192²): one warm-up call, five calls timed on
the host clock (``blocking=True``, so each ends in a synchronize), then
one call under ``torch.profiler``. Prints one JSON line per run: the five
walltimes and GCell/s, the device time and count of each kernel in the
profiled call, and the kernels' share of the mean unprofiled walltime.
For each run that resolves to ``monotile`` it then prints the host time of
each stage of the call (:func:`monotile_host_split`). Needs a CUDA card;
there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from . import Grid
from .models import conway, hotspot, jacobi

__all__ = ["main", "main_paths"]

JACOBI5_COEFS = [0.15, 0.2, 0.25, 0.1, 0.3]  # the JAX package's bench.py:244


def main_paths(device) -> dict:
    """The port's main-path runs, ``name -> (grid, run, n, options)``:
    ``run(grid, n, **options)`` is the app's entry point and returns
    ``(grid, update)``. Grids are made from numpy seeds on ``device``."""
    rng = np.random.default_rng(7)

    def hot(size):
        return Grid(hotspot.HotspotCell(
            temp=torch.tensor(rng.uniform(70, 90, (size, size)).astype(np.float32), device=device),
            power=torch.tensor(rng.uniform(0, 1e-3, (size, size)).astype(np.float32), device=device),
        ))

    j5 = jacobi.make_kernel("jacobi5_general", JACOBI5_COEFS)

    def run_jacobi5(grid, n, **options):
        return jacobi.run(grid, j5, n, **options)

    auto = {"backend": "auto"}
    return {
        "hotspot 1024^2 auto": (hot(1024), hotspot.run, 1000, auto),
        "hotspot 8192^2 auto": (hot(8192), hotspot.run, 200, auto),
        "jacobi5 8192^2 tiling linecache": (
            jacobi.init_grid(8192, 8192, device=device), run_jacobi5, 200,
            {"backend": "tiling", "window_mode": "linecache"},
        ),
        "jacobi5 8192^2 auto": (jacobi.init_grid(8192, 8192, device=device), run_jacobi5, 200, auto),
        "jacobi5 1024^2 auto": (jacobi.init_grid(1024, 1024, device=device), run_jacobi5, 1000, auto),
        "conway 8192^2 auto": (
            Grid(torch.tensor(rng.random((8192, 8192)) < 0.35, device=device)), conway.run, 200, auto,
        ),
    }


def _device_us(event) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def trace(name, grid, run, n, options) -> tuple[dict, object]:
    """The run's record, and its transition function."""
    run(grid, n, **options)  # warm up
    walltimes = [run(grid, n, **options)[1].get_walltime() for _ in range(5)]
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        _, update = run(grid, n, **options)
    kernels = {
        e.key: {"ms": _device_us(e) / 1e3, "count": e.count}
        for e in prof.key_averages()
        if _device_us(e) > 0
    }
    device_ms = sum(k["ms"] for k in kernels.values())
    mean_s = sum(walltimes) / len(walltimes)
    cells = grid.shape[0] * grid.shape[1] * n
    return {
        "run": name,
        "backend": getattr(update, "resolved_backend", "tiling"),
        "config": update.resolved_config,
        "walltime_s": walltimes,
        "gcell_per_s": [cells / t / 1e9 for t in walltimes],
        "profiled_walltime_s": update.get_walltime(),
        "device_kernels": kernels,
        "device_ms": device_ms,
        "kernel_share_of_walltime": device_ms / 1e3 / mean_s,
    }, update.params.transition_function


def monotile_host_split(grid, tf, n, reps: int = 20) -> dict:
    """Mean host microseconds of each stage of one ``monotile`` call through
    ``auto`` (``StencilUpdate._update`` -> ``monotile`` -> the C launcher),
    each stage timed on its own over ``reps`` runs: the backend choice, the
    plan, the halo and time-dependent-value lookup, ``kernel_fields``, the
    output and exchange buffers, the whole ``monotile`` call up to its
    return (``launch_us`` is that less the fields and buffers: the
    ``ctypes`` call with the C side's attribute check and cooperative
    launch), and the wait in ``synchronize``; beside them the kernel's
    device time (CUDA events) and the walltime of a whole blocking call as
    the updater counts it (``get_walltime``, as :func:`trace` reports)."""
    from .backends import auto, cuda_lib
    from .backends import monotile as mt
    from .backends.base import resolve_halo

    def mean_us(fn) -> float:
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - start) / reps * 1e6

    H, W = grid.shape
    limits = cuda_lib.device_limits(grid.device)
    cell_bytes = cuda_lib.cell_smem_bytes(grid.arrays, tf)
    update = mt.StencilUpdate(mt.StencilUpdate.Params(transition_function=tf, n_iterations=n, blocking=True))
    halo = resolve_halo(None, grid)
    plan = mt.require_plan(H, W, tf, cell_bytes, limits)
    fields = cuda_lib.kernel_fields(grid.arrays, tf, halo, 0)
    side = len(fields.variant) * plan.q * tf.stencil_radius * (W + 2 * tf.stencil_radius)
    stream = torch.cuda.current_stream(grid.device).cuda_stream
    out = {
        "choose_backend_us": mean_us(lambda: auto.choose_backend(grid, tf)),
        "require_plan_us": mean_us(
            lambda: mt.require_plan(H, W, tf, cuda_lib.cell_smem_bytes(grid.arrays, tf),
                                    cuda_lib.device_limits(grid.device))),
        "halo_and_tdv_us": mean_us(lambda: (resolve_halo(None, grid), update._tdv_lookup(grid))),
        "kernel_fields_us": mean_us(lambda: cuda_lib.kernel_fields(grid.arrays, tf, halo, 0)),
        "buffers_us": mean_us(lambda: ([torch.empty_like(t) for t in fields.variant],
                                       mt._exchange(grid.device, stream, 4 * plan.n_ctas * side
                                                    * fields.variant[0].element_size(), plan.n_ctas))),
    }
    call, wait, device = [], [], []
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        mt.monotile(grid.arrays, tf, halo, offset=0, n_iterations=n, plan=plan)
        stop.record()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        call.append((t1 - t0) * 1e6)
        wait.append((t2 - t1) * 1e6)
        device.append(start.elapsed_time(stop) * 1e3)
    out["monotile_call_us"] = sum(call) / len(call)
    out["launch_us"] = out["monotile_call_us"] - out["kernel_fields_us"] - out["buffers_us"]
    out["synchronize_us"] = sum(wait) / len(wait)
    out["kernel_device_us"] = sum(device) / len(device)
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        whole = auto.StencilUpdate(auto.StencilUpdate.Params(transition_function=tf, n_iterations=n, blocking=True))
        whole(grid)
        walls.append(whole.get_walltime() * 1e6)
    out["walltime_us"] = walls
    out["host_loss_us"] = sum(walls) / len(walls) - out["kernel_device_us"]
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="trace_cells", description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the JSON lines to this file")
    parser.add_argument("--runs", default="", help="trace only the runs whose names contain one of these "
                        "comma-separated strings (default: every run)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_cells: no CUDA device is available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card, flush=True)
    lines = []
    wanted = [w for w in args.runs.split(",") if w]
    for name, (grid, run, n, options) in main_paths(torch.device("cuda", 0)).items():
        if wanted and not any(w in name for w in wanted):
            continue
        result, tf = trace(name, grid, run, n, options)
        result["card"] = card
        lines.append(json.dumps(result))
        print(lines[-1], flush=True)
        if result["backend"] == "monotile":
            split = monotile_host_split(grid, tf, n)
            lines.append(json.dumps({"run": name, "monotile_host_split": split, "card": card}))
            print(lines[-1], flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
