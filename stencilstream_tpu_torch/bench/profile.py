"""Profiler hooks and the kernels' work counts.

Counterpart of ``stencilstream_tpu/bench/profile.py``, the analog of the
reference's offline profiling (AOCL ``profile.json`` Gantt rendering,
``scripts/gantt_of_profile.jl:16-37``; Nsight Compute metric extraction,
``scripts/benchmark-common.jl:229-282``):

* :func:`trace` captures a ``torch.profiler`` trace (a Chrome trace of
  every kernel, host event and span of the port); :func:`profiled` sums a
  call's device time by kernel, the package's own (``ss::..._kernel``) apart
  from everything else on the card.
* :func:`kernel_stats` counts what one pass of the port's kernels moves and
  computes, exactly, from the geometry they run: bytes read from and
  written to device memory, cells computed (and the lanes that compute them,
  in whole 32-column chunks and runs), and kernel launches. No profiler can
  count bytes on the card (``ncu`` does not run there), and the counts need
  none: every load and store of the kernels is fixed by the geometry. With
  a measured walltime they give achieved bandwidth and operation rates.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile

import torch

from .. import tracing

__all__ = ["trace", "profiled", "device_us", "kernel_stats"]

#: The Chrome trace row (thread id) of the port's spans: no thread of the
#: process has id 0.
SPAN_ROW = 0


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Capture a ``torch.profiler`` trace of the enclosed block and write it
    as ``<log_dir>/trace.json`` (Chrome trace format; default directory
    ``stencilstream-trace`` under the temporary directory)::

        with bench.profile.trace("traces/hotspot"):
            update(grid)

    The port's spans (:mod:`..tracing`) are on for the block; the file holds
    them too, as complete events on the profiler's clock in a row of their
    own (``stencilstream_tpu_torch spans``), each with its call id, parent
    and attributes under ``args``.
    """
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "stencilstream-trace")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    was_on = tracing.on
    tracing.enable()
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield log_dir
    finally:
        if not was_on:
            tracing.disable()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        data = json.load(f)
    data["traceEvents"].extend(_span_events(tracing.collect(), data.get("baseTimeNanoseconds", 0)))
    with open(path, "w") as f:
        json.dump(data, f)


def _span_events(spans, base_ns: int) -> list[dict]:
    """The port's spans as Chrome trace events in microseconds from
    ``base_ns`` (a trace's ``baseTimeNanoseconds``), in the row
    ``SPAN_ROW`` of this process, named by a metadata event."""
    pid = os.getpid()
    events = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": SPAN_ROW,
               "args": {"name": "stencilstream_tpu_torch spans"}}]
    for s in spans:
        events.append({
            "ph": "X", "name": s.name, "cat": "stencilstream", "pid": pid, "tid": SPAN_ROW,
            "ts": (tracing.to_unix_ns(s.start_ns) - base_ns) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
            "args": {"call": s.call, "parent": s.parent, **s.attrs},
        })
    return events


def device_us(event) -> float:
    """An averaged profiler event's own device time, in microseconds."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def profiled(fn) -> tuple:
    """``fn()`` under ``torch.profiler``: its result, and the device time
    and count of each of the package's kernels (``ss::..._kernel``) and of
    every other operation on the card (copies, fills, PyTorch's own
    kernels), in ms."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        result = fn()
    kernels, other = {}, {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or device_us(e) <= 0:
            continue
        ours = "ss::" in e.key and "_kernel" in e.key
        (kernels if ours else other)[e.key] = {"ms": device_us(e) / 1e3, "count": e.count}
    return result, kernels, other


WARP = 32


def _covered(n_out: int, tile: int, halo: int, lo: int, hi: int) -> int:
    """Cells of ``[lo, hi)`` that the windows of ``ceil(n_out / tile)``
    tiles read along one axis: tile ``i``'s window is ``[i*tile - halo,
    (i+1)*tile + halo)``."""
    return sum(
        max(0, min((i + 1) * tile + halo, hi) - max(i * tile - halo, lo)) for i in range(-(-n_out // tile))
    )


def _lanes(h: int, w: int, run: int) -> int:
    """Cells a thread map of ``run``-row runs and 32-column chunks covers
    on an ``h x w`` window."""
    return -(-h // run) * run * -(-w // WARP) * WARP


def _tile_launch(core, tile, halo, narrowing, run, rows_in, cols_in) -> dict:
    """One tile-pass launch (``csrc/tile_pass.cu``) over a core of ``core``
    cells in ``tile`` tiles: each window, the tile and ``halo`` cells a
    side, is staged from the cells in ``rows_in x cols_in`` (core
    coordinates of the cells stored and inside the grid; the rest are
    staged as the halo value, not read), sub-step ``s`` computes it narrowed
    by ``narrowing[s]`` cells on its two sides together
    (``backends.tile_pass.pass_narrowing``), and the core is written."""
    (h, w), (th, tw) = core, tile
    n_tiles = -(-h // th) * -(-w // tw)
    sizes = [(th + 2 * halo - m, tw + 2 * halo - m) for m in narrowing]
    return {
        "read_cells": _covered(h, th, halo, *rows_in) * _covered(w, tw, halo, *cols_in),
        "written_cells": h * w,
        "computed": n_tiles * sum(a * b for a, b in sizes),
        "lanes": n_tiles * sum(_lanes(a, b, run) for a, b in sizes),
        "launches": 1,
    }


def _add(parts: list[dict]) -> dict:
    return {k: sum(p[k] for p in parts) for k in parts[0]}


def _line_cache_pass(H, W, radius, steps, strip, panel, segment, variant_bytes, invariant_bytes) -> dict:
    """One line-cache launch (``csrc/line_cache.cu``): a CTA per (panel,
    segment) walks its segment and, above it, the warm-up rows (``halo``
    rows for the first segment) strip by strip; each strip stages
    ``strip + 2r`` rows of each variant field and ``strip + halo + r`` rows
    of each invariant field, the panel and ``halo`` columns a side, cells
    outside the grid not read; every level ``s`` computes ``strip`` rows of
    the window narrowed by ``r*s`` a side."""
    from ..backends.line_cache import warmup_rows

    halo = radius * steps
    window = panel + 2 * halo
    warmup = warmup_rows(radius, steps, strip)
    cols = _covered(W, panel, halo, 0, W)
    n_panels = -(-W // panel)
    var_rows = inv_rows = strips = 0
    for y0 in range(0, H, segment):
        warm = halo if y0 == 0 else warmup
        r0 = y0 - warm + halo
        n_strips = -(-(warm + min(segment, H - y0)) // strip)
        strips += n_strips
        for g in range(r0, r0 + n_strips * strip, strip):
            var_rows += max(0, min(g + strip, H) - max(g - 2 * radius, 0))
            inv_rows += max(0, min(g + strip, H) - max(g - halo - radius, 0))
    levels = [window - 2 * radius * s for s in range(1, steps + 1)]
    return {
        "read_bytes": cols * (var_rows * variant_bytes + inv_rows * invariant_bytes),
        "written_bytes": H * W * variant_bytes,
        "computed": n_panels * strips * strip * sum(levels),
        "lanes": n_panels * strips * strip * sum(-(-c // WARP) * WARP for c in levels),
        "launches": 1,
    }


def _resident_call(H, W, radius, n_steps, band, q, variant_bytes, invariant_bytes) -> dict:
    """One resident-grid launch (``csrc/monotile.cu``): each CTA loads its
    band and ``q*r`` rows a side, inside the grid, once, and stores its band
    once; a group of ``g`` sub-steps computes, within the grid, the band and
    ``m`` rows a side for ``m = (g-1)*r`` down to 0; between groups each CTA
    publishes its top and bottom ``q*r`` rows (and halo columns) to an
    exchange buffer in device memory and pulls its neighbours'."""
    qr = q * radius
    n_full, last = divmod(n_steps, q)
    read_rows = computed = 0
    for top in range(0, H, band):
        read_rows += min(top + band + qr, H) - max(top - qr, 0)
        rows = [min(top + band + m * radius, H) - max(top - m * radius, 0) for m in range(q)]
        computed += W * (n_full * sum(rows) + sum(rows[:last]))
    n_ctas = -(-H // band)
    n_groups = n_full + (last > 0)
    return {
        "read_bytes": read_rows * W * (variant_bytes + invariant_bytes),
        "written_bytes": H * W * variant_bytes,
        "computed": computed,
        "launches": 1,
        "exchange_bytes": max(n_groups - 1, 0) * n_ctas * 2 * 2 * qr * (W + 2 * radius) * variant_bytes,
    }


def kernel_stats(
    grid_shape: tuple[int, int],
    variant_bytes: int,
    invariant_bytes: int,
    *,
    radius: int,
    n_subiterations: int,
    n_iterations: int,
    config: dict,
    run: int = 8,
    measured_walltime: float | None = None,
    flops_per_cell: float = 0.0,
    spec=None,
    dtype: str = "float32",
    reach=None,
) -> dict:
    """What one pass of the kernel a configuration runs reads, writes and
    computes, and a run's totals.

    ``variant_bytes`` and ``invariant_bytes`` are one cell's bytes as the
    kernels hold them (``backends.cuda_lib.cell_field_bytes``: the kernels
    stage every invariant field, read or not); ``run`` is the rows of one
    thread's run (``backends.line_cache.run_rows``: 8 with one variant
    field, 1 with more). ``reach``: each sub-step's ``(lo, hi)`` where the
    functor declares it (``backends.cuda_lib.tile_reach``), which sets the
    tile pass's halo (``backends.tile_pass.pass_halo``) and narrowing.
    ``config`` is the ``resolved_config`` of the backend that ran:

    * ``tiling`` with ``window_mode="clamped"`` (``tile_rows``,
      ``tile_cols``, ``iters_per_pass``): one tile-pass launch a pass;
    * ``tiling`` with ``window_mode="linecache"`` (``strip_rows``,
      ``panel_cols``, ``segment_rows``, ``iters_per_pass``): one line-cache
      launch a pass;
    * ``distributed`` (``mesh``, ``shard``, ``stored_halo``, tile and p):
      a tile-pass launch in extended mode for each shard a pass;
    * ``ring`` (``ring``, ``chunk_rows``, ``n_chunks``, tile and p): a pass
      is one position's ``p`` iterations over the grid, one launch a chunk;
    * ``monotile`` (``band``, ``q``, from ``backends.monotile.require_plan``):
      the whole call is one pass of ``n_iterations``, one launch.

    ``per_pass`` holds ``hbm_read_bytes``, ``hbm_write_bytes``,
    ``computed_cell_substeps`` (window cells computed, sub-steps counted),
    ``lane_cell_substeps`` (the lanes of whole runs and 32-column chunks
    that compute them; not for ``monotile``), ``redundancy`` (computed over
    useful cell-substeps) and ``launches``. ``launches`` is one call's (a
    partial last pass launches as a full one, and is counted as one).
    With ``measured_walltime``: achieved bandwidth, its share of the
    spec's HBM rate, the useful operations' share of the peak of ``dtype``,
    and the memory time at the derated rate over the walltime.
    """
    from ..backends.tile_pass import pass_halo, pass_narrowing
    from .model import GpuSpec

    H, W = grid_shape
    r, k = radius, n_subiterations
    if "band" in config:
        kernel, n_passes = "monotile", 1
        steps = n_iterations * k
        c = _resident_call(H, W, r, steps, config["band"], config["q"], variant_bytes, invariant_bytes)
        read, write = c["read_bytes"], c["written_bytes"]
    else:
        p = config["iters_per_pass"]
        steps = p * k
        halo = r * steps
        window = pass_halo(r, p, k, reach)  # the tile pass's own halo
        narrowing = [lo + hi for lo, hi in pass_narrowing(r, p, k, reach)]
        n_passes = -(-n_iterations // p) if n_iterations else 0
        if config.get("window_mode") == "linecache":
            kernel = "line_cache"
            c = _line_cache_pass(H, W, r, steps, config["strip_rows"], config["panel_cols"],
                                 config["segment_rows"], variant_bytes, invariant_bytes)
            read, write = c["read_bytes"], c["written_bytes"]
        else:
            kernel = "tile_pass"
            tile = (config["tile_rows"], config["tile_cols"])
            if "mesh" in config:
                (ny, nx), (h, w), (hr, hc) = config["mesh"], config["shard"], config["stored_halo"]
                c = _add([
                    _tile_launch((h, w), tile, window, narrowing, run,
                                 (max(-hr, -iy * h), min(h + hr, H - iy * h)),
                                 (max(-hc, -ix * w), min(w + hc, W - ix * w)))
                    for iy in range(ny) for ix in range(nx)
                ])
            elif "ring" in config:
                ch, look = config["chunk_rows"], halo
                c = _add([
                    _tile_launch((ch, W), tile, window, narrowing, run,
                                 (max(-look, -j * ch), min(ch + look, H - j * ch)), (0, W))
                    for j in range(config["n_chunks"])
                ])
                laps = -(-n_iterations // (config["ring"] * p)) if n_iterations else 0
                n_passes = laps * config["ring"]
            else:
                c = _tile_launch((H, W), tile, window, narrowing, run, (0, H), (0, W))
            read = c["read_cells"] * (variant_bytes + invariant_bytes)
            write = c["written_cells"] * variant_bytes
    useful = H * W * steps
    per_pass = {
        "hbm_read_bytes": read,
        "hbm_write_bytes": write,
        "computed_cell_substeps": c["computed"],
        "redundancy": c["computed"] / max(useful, 1),
        "launches": c["launches"],
    }
    if "lanes" in c:
        per_pass["lane_cell_substeps"] = c["lanes"]
    stats = {
        "kernel": kernel,
        "config": dict(config),
        "per_pass": per_pass,
        "n_passes": n_passes,
        "launches": n_passes * c["launches"],
        "run_hbm_bytes": n_passes * (read + write),
        "run_useful_flops": H * W * n_iterations * flops_per_cell,
    }
    if "exchange_bytes" in c:
        stats["exchange_bytes"] = c["exchange_bytes"]
    if measured_walltime:
        spec = spec or GpuSpec.detect()
        bw = stats["run_hbm_bytes"] / measured_walltime
        stats["achieved_hbm_bw_gbps"] = bw / 1e9
        stats["hbm_bw_fraction"] = bw / spec.hbm_bandwidth
        stats["flop_utilization"] = stats["run_useful_flops"] / measured_walltime / spec.flop_rate(dtype)
        stats["memory_time_fraction"] = (
            stats["run_hbm_bytes"] / (spec.hbm_efficiency * spec.hbm_bandwidth) / measured_walltime
        )
    return stats
