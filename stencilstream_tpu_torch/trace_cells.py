"""Where the time goes in the port's main-path runs, on one NVIDIA card.

    python -m stencilstream_tpu_torch.trace_cells [--out trace.json] [--runs 1024,linecache]

Drives each main-path run (:func:`main_paths`, which ``chip_smoke.py``
drives too) through the entry point a user calls (HotSpot 1024² and
8192², Jacobi5 8192² in both tiling window modes, Jacobi5 1024², Conway
8192², FDTD's mono-benchmark with its time axis cut: coef 1024² and
512², render 1024² through the line cache, lut 1024²; ``convection.run``
of the JAX bench's experiment: 3072×1024 in float32 and float64 through
``auto``, 384×128 in float64 through ``auto``, 3072×1024 in float32 through
the line cache, and the folded variant (``folded=True``) at 3072×1024 in
float32 and float64 through ``auto`` and in float32 through the line cache;
and on narrow storage (``backends/storage_cast.py``), as
the JAX bench's ``bf16_storage`` rows store them: Jacobi5 8192² in
bfloat16 through ``auto`` and through the line cache, HotSpot 8192² and
FDTD coef 1024² in bfloat16 through ``auto``, Jacobi5 1024² in bfloat16
through ``auto``, Jacobi5 8192² in float8 e4m3 through ``tiling``; and
the multi-device backends on meshes whose positions all name the one card,
:func:`multi_device_paths`): one warm-up call, five calls timed on
the host clock (``blocking=True``, so each ends in a synchronize), then
one call under ``torch.profiler``. Prints one JSON line per run: the five
walltimes and GCell/s, the card's SM clock and power draw meanwhile
(:class:`CardSampler`), the device time and count of each of the package's
kernels in the profiled call, the device time of everything else the call
ran on the card, and the kernels' share of the mean unprofiled walltime
(for convection, :func:`trace_convection`: the pseudo-transient updates'
walltime and GCell/s, as the JAX CLI's "transient computation time", and
the whole run's device share and idle time a block). Needs a CUDA card;
there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys

import numpy as np
import torch

from . import Grid
from .backends.storage_cast import CastStorageKernel, cast_storage
from .bench.profile import profiled
from .models import convection, conway, fdtd, hotspot, jacobi

__all__ = [
    "CardSampler", "convection_experiment", "convection_run", "convection_updates", "fdtd_run", "kernel_launch",
    "main", "main_paths", "multi_device_paths", "profiled",
]

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

    def narrow_jacobi5(side, storage):
        """Jacobi5's bench grid stored as ``storage``, and its run."""
        kernel = CastStorageKernel(j5, storage)
        grid = cast_storage(jacobi.init_grid(side, side, device=device), storage)
        return grid, lambda grid, n, **options: jacobi.run(grid, kernel, n, **options)

    def run_hotspot_bf16(grid, n, **options):
        kernel = CastStorageKernel(hotspot.derive_coefficients(*grid.shape))
        return hotspot.run(grid, n, kernel=kernel, **options)

    bf16, e4m3 = torch.bfloat16, torch.float8_e4m3fn
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
        "fdtd coef 1024^2 auto": fdtd_run("coef", 1024, "inline", device, **auto),
        "fdtd coef 512^2 auto": fdtd_run("coef", 512, "precompute_on_host", device, **auto),
        "fdtd render 1024^2 tiling linecache": fdtd_run(
            "render", 1024, "precompute_on_device", device, backend="tiling", window_mode="linecache"),
        "fdtd lut 1024^2 auto": fdtd_run("lut", 1024, "inline", device, **auto),
        "fdtd coef 2048^2 auto": fdtd_run("coef", 2048, "inline", device, **auto),
        "convection f32 3072x1024 auto": convection_run(1024, np.float32, device, **auto),
        "convection f64 3072x1024 auto": convection_run(1024, np.float64, device, **auto),
        "convection f64 384x128 auto": convection_run(128, np.float64, device, **auto),
        "convection f32 3072x1024 tiling linecache": convection_run(
            1024, np.float32, device, backend="tiling", window_mode="linecache"),
        "convection folded f32 3072x1024 auto": convection_run(1024, np.float32, device, folded=True, **auto),
        "convection folded f64 3072x1024 auto": convection_run(1024, np.float64, device, folded=True, **auto),
        "convection folded f32 3072x1024 tiling linecache": convection_run(
            1024, np.float32, device, backend="tiling", window_mode="linecache", folded=True),
        "jacobi5 bf16 8192^2 auto": (*narrow_jacobi5(8192, bf16), 200, auto),
        "jacobi5 bf16 8192^2 tiling linecache": (
            *narrow_jacobi5(8192, bf16), 200, {"backend": "tiling", "window_mode": "linecache"}),
        "hotspot bf16 8192^2 auto": (cast_storage(hot(8192)), run_hotspot_bf16, 200, auto),
        "fdtd coef bf16 1024^2 auto": fdtd_run("coef", 1024, "inline", device, storage=bf16, **auto),
        "jacobi5 bf16 1024^2 auto": (*narrow_jacobi5(1024, bf16), 1000, auto),
        "jacobi5 e4m3 8192^2 tiling": (*narrow_jacobi5(8192, e4m3), 200, {"backend": "tiling"}),
        **multi_device_paths(device, hot),
    }


def multi_device_paths(device, hot) -> dict:
    """The multi-device backends' runs on a mesh that names ``device`` at
    every position (its shards share one card): HotSpot 8192², n=200,
    through ``distributed`` on (2, 2) and (4, 1) at the default p=4 and at
    p=8, and through ``ring`` on 4 positions at p=2 (25 laps); Jacobi5 8192²
    and FDTD coef 1024² (its TDV on each position) through ``distributed``
    (2, 2); the JAX bench's strong-scaling size, HotSpot 2048², n=256, on
    (1, 1), (2, 1) and (2, 2), beside its ``auto`` run (tiling)."""
    from .parallel import make_mesh

    def mesh(*shape):
        return make_mesh(shape=shape, devices=[device] * int(np.prod(shape)))

    big, small = hot(8192), hot(2048)
    j5 = jacobi.make_kernel("jacobi5_general", JACOBI5_COEFS)

    def run_jacobi5(grid, n, **options):
        return jacobi.run(grid, j5, n, **options)

    dist = {"backend": "distributed"}
    return {
        "hotspot 8192^2 distributed 2x2": (big, hotspot.run, 200, {**dist, "mesh": mesh(2, 2)}),
        "hotspot 8192^2 distributed 2x2 p=8": (big, hotspot.run, 200, {**dist, "mesh": mesh(2, 2),
                                                                        "iters_per_pass": 8}),
        "hotspot 8192^2 distributed 4x1": (big, hotspot.run, 200, {**dist, "mesh": mesh(4, 1)}),
        "hotspot 8192^2 distributed 4x1 p=8": (big, hotspot.run, 200, {**dist, "mesh": mesh(4, 1),
                                                                        "iters_per_pass": 8}),
        "hotspot 8192^2 ring 4": (big, hotspot.run, 200, {"backend": "ring", "mesh": mesh(4), "iters_per_pass": 2}),
        "jacobi5 8192^2 distributed 2x2": (jacobi.init_grid(8192, 8192, device=device), run_jacobi5, 200,
                                           {**dist, "mesh": mesh(2, 2)}),
        "fdtd coef 1024^2 distributed 2x2": fdtd_run("coef", 1024, "inline", device, **dist, mesh=mesh(2, 2)),
        "hotspot 2048^2 auto": (small, hotspot.run, 256, {"backend": "auto"}),
        **{f"hotspot 2048^2 distributed {y}x{x}": (small, hotspot.run, 256, {**dist, "mesh": mesh(y, x)})
           for y, x in ((1, 1), (2, 1), (2, 2))},
    }


def fdtd_run(resolver: str, side: int, strategy, device, storage=None, **options) -> tuple:
    """FDTD's mono-benchmark with its time axis cut, on a side^2 grid, as
    one main-path run ``(grid, run, n, options)``: the experiment's whole
    run (~8.2k iterations) in one call of ``build_simulation``'s updater
    with the TDV ``strategy`` (``run`` also takes the call's
    ``iteration_offset``); with ``storage``, the grid's float32 fields are
    stored in that dtype and the kernel wrapped (``CastStorageKernel``)."""
    parameters = fdtd.Parameters.from_json(fdtd.mono_benchmark(side))
    res = fdtd.RESOLVERS[resolver](parameters)

    def run_fdtd(grid, n, iteration_offset=0, **kw):
        update, _ = fdtd.build_simulation(parameters, res, n_iterations=n, **kw)
        p = update.get_params()
        p.iteration_offset = iteration_offset
        if storage is not None:
            p.transition_function = CastStorageKernel(p.transition_function, storage)
        return update(grid), update

    grid = fdtd.init_grid(parameters, res, device=device)
    if storage is not None:
        grid = cast_storage(grid, storage)
    return grid, run_fdtd, parameters.n_timesteps(), {"tdv_strategy": strategy, **options}


def convection_experiment(res: int) -> convection.Experiment:
    """The JAX bench's convection experiment
    (``stencilstream_tpu/bench/__main__.py:116-150``) at ``res``: an
    ``(3 res) x res`` grid, 2 timesteps of at most 400 pseudo-transient
    iterations in blocks of 50."""
    return convection.Experiment(
        lx=3.0, ly=1.0, px=1.5, py=0.5, eta0=1.0, DcT=1.0, deltaT=1.0, Ra=1e7, Pra=1e3, res=res,
        iterMax=400, nt=2, nout=1, nerr=50, epsilon=1e-3, dmp=2.0,
    )


def convection_run(res: int, dtype, device, **options) -> tuple:
    """``convection.run`` of :func:`convection_experiment` at ``res`` in
    ``dtype`` as one main-path run ``(grid, run, n, options)``: ``grid`` is
    the run's initial grid (``init_grid``; the run makes its own from the
    experiment), ``n`` the experiment's ``iterMax``; ``run(grid, n,
    nt=None, **kw)`` runs it with ``iterMax = n`` (and ``nt`` timesteps when
    given) and returns ``convection.run``'s ``(grid, info)``."""
    e = convection_experiment(res)

    def run_convection(grid, n, nt=None, **kw):
        cut = dataclasses.replace(e, iterMax=n, nt=e.nt if nt is None else nt)
        return convection.run(cut, dtype=dtype, verbose=False, device=device, **kw)

    return convection.init_grid(e, dtype, device=device), run_convection, e.iterMax, options


def convection_updates(info: dict) -> list:
    """The updaters of one ``convection.run``: the lean one (when the run
    split its blocks), the full one, the thermal one."""
    return [u for u in (info["lean_update"], info["pt_update"], info["thermal_update"]) if u is not None]


def kernel_launch(update, cell, halo) -> tuple:
    """One launch of the kernel ``update`` resolved to, at its geometry, on
    ``cell``: ``(kernel, fn, plain, what, n)``. The tile pass and the line
    cache run one pass of the update's ``p`` iterations from 0, the
    resident grid one call of its ``n``; ``plain`` is the same work in the
    plain version, ``n`` the iterations it runs."""
    from .backends import line_cache as lc
    from .backends import monotile as mt
    from .backends import tile_pass as tp

    tf = update.params.transition_function
    cfg = getattr(update, "resolved_config", None) or {}
    if getattr(update, "resolved_backend", None) == "monotile" or isinstance(update, mt.StencilUpdate):
        n = update.params.n_iterations
        return ("monotile", lambda: mt.monotile(cell, tf, halo, offset=0, n_iterations=n),
                lambda: mt.monotile_plain(cell, tf, halo, offset=0, n_iterations=n), f"one call of n={n}", n)
    n = cfg["iters_per_pass"]
    kw = dict(i_start=0, offset=0, n_iterations=n, iters_per_pass=n)
    plain = lambda: tp.tile_pass_plain(cell, tf, halo, **kw)  # noqa: E731
    if cfg["window_mode"] == "linecache":
        geometry = {k: cfg[k] for k in ("strip_rows", "panel_cols", "segment_rows")}
        return ("line_cache", lambda: lc.line_cache_pass(cell, tf, halo, **geometry, **kw), plain,
                f"one pass of p={n}, {geometry}", n)
    tile = (cfg["tile_rows"], cfg["tile_cols"])
    return ("tile_pass", lambda: tp.tile_pass(cell, tf, halo, tile=tile, **kw), plain,
            f"one pass of p={n}, tile {tile}", n)


class CardSampler:
    """The card's SM clock (MHz) and power draw (W), sampled by
    ``nvidia-smi`` every ``period_ms`` while the ``with`` block runs (the
    block starts once the first sample is in); ``summary`` holds each
    one's minimum, median and maximum and the number of samples."""

    def __init__(self, period_ms: int = 20):
        self.period_ms = period_ms
        self.summary: dict = {}

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
             f"-lms={self.period_ms}"], stdout=subprocess.PIPE, text=True)
        self.first = self.proc.stdout.readline()
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        rest, _ = self.proc.communicate(timeout=30)
        rows = [tuple(float(v) for v in line.split(",")) for line in (self.first + rest).splitlines()[1:]
                if line.strip()]
        for j, key in enumerate(("sm_clock_mhz", "power_w")):
            values = sorted(row[j] for row in rows)
            self.summary[key] = [values[0], values[len(values) // 2], values[-1]] if values else []
        self.summary["samples"] = len(rows)
        return False


def trace(name, grid, run, n, options) -> dict:
    """The run's record."""
    run(grid, n, **options)  # warm up
    with CardSampler() as card:
        walltimes = [run(grid, n, **options)[1].get_walltime() for _ in range(5)]
    (_, update), kernels, other = profiled(lambda: run(grid, n, **options))
    device_ms = sum(k["ms"] for k in kernels.values())
    cells = grid.shape[0] * grid.shape[1] * n
    return {
        "run": name,
        "backend": getattr(update, "resolved_backend", update.__module__.rsplit(".", 1)[-1]),
        "config": update.resolved_config,
        "walltime_s": walltimes,
        "gcell_per_s": [cells / t / 1e9 for t in walltimes],
        "card_during_runs": card.summary,
        "profiled_walltime_s": update.get_walltime(),
        "device_kernels": kernels,
        "device_ms": device_ms,
        "other_device_ms": sum(k["ms"] for k in other.values()),
        "kernel_share_of_walltime": device_ms / 1e3 / (sum(walltimes) / len(walltimes)),
    }


def trace_convection(name, grid, run, n, options) -> dict:
    """A convection run's record: walltime and GCell/s of its
    pseudo-transient updates (``pt_walltime``, as the JAX CLI's "transient
    computation time") and the whole run's ``total_time``, five calls each,
    with the card's clock and power meanwhile; in the profiled call the
    device time of the pseudo-transient kernels, of the thermal kernels, of
    the initial grid's upload (``init_grid``, before the run's clock
    starts) and of every other operation on the card (the error
    reductions and their host reads); the pseudo-transient kernels' share
    of the mean pseudo-transient walltime, the device's share of the mean
    whole run, and the whole run's time a block of ``nerr`` iterations in
    which the card was busy with nothing."""
    run(grid, n, **options)  # warm up
    with CardSampler() as card:
        infos = [run(grid, n, **options)[1] for _ in range(5)]
    (_, info), kernels, other = profiled(lambda: run(grid, n, **options))
    updates = convection_updates(info)
    pt_updates = updates[:-1]
    cells = grid.shape[0] * grid.shape[1] * sum(s["iters"] for s in info["stats"])
    walltimes = [i["pt_walltime"] for i in infos]
    totals = [i["total_time"] for i in infos]
    thermal_ms = sum(k["ms"] for key, k in kernels.items() if "Thermal" in key)
    pt_ms = sum(k["ms"] for k in kernels.values()) - thermal_ms
    upload_ms = sum(k["ms"] for key, k in other.items() if "HtoD" in key)
    other_ms = sum(k["ms"] for k in other.values()) - upload_ms
    # A block: nerr - 1 lean iterations and one full one, or nerr full ones.
    n_blocks = sum(s["iters"] for s in info["stats"]) // sum(u.params.n_iterations for u in pt_updates)
    mean_total = sum(totals) / len(totals)
    return {
        "run": name,
        "backend": getattr(info["pt_update"], "resolved_backend", "tiling"),
        "config": {"lean": getattr(info["lean_update"], "resolved_config", None),
                   "full": getattr(info["pt_update"], "resolved_config", None),
                   "thermal": getattr(info["thermal_update"], "resolved_config", None)},
        "stats": info["stats"],
        "walltime_s": walltimes,
        "gcell_per_s": [cells / t / 1e9 for t in walltimes],
        "total_time_s": totals,
        "card_during_runs": card.summary,
        "profiled_walltime_s": info["pt_walltime"],
        "profiled_total_time_s": info["total_time"],
        "device_kernels": kernels,
        "other_device": other,
        "pt_device_ms": pt_ms,
        "thermal_device_ms": thermal_ms,
        "upload_device_ms": upload_ms,
        "other_device_ms": other_ms,
        "kernel_share_of_walltime": pt_ms / 1e3 / (sum(walltimes) / len(walltimes)),
        "device_share_of_total_time": (pt_ms + thermal_ms + other_ms) / 1e3 / mean_total,
        "idle_ms_per_block": (mean_total * 1e3 - pt_ms - thermal_ms - other_ms) / n_blocks,
    }


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
        if name.startswith("convection"):
            result = trace_convection(name, grid, run, n, options)
        else:
            result = trace(name, grid, run, n, options)
        result["card"] = card
        lines.append(json.dumps(result))
        print(lines[-1], flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
