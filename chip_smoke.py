#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (stencilstream_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit code when it fails:

1. require a CUDA card; print its name and power limit (nvidia-smi);
2. build the CUDA kernels from ``stencilstream_tpu_torch/csrc`` (one nvcc
   per source, all at once) and print how long the build took and what
   ptxas reports;
3. hold each kernel against its plain PyTorch version on the card: HotSpot
   on the tile-pass and resident-grid kernels; every other functor (eight
   Jacobi variants, Conway, the probe) on all three; the line-cache kernel
   with HotSpot, Jacobi5, Conway and the probe. Odd shapes, grids smaller than a
   tile or strip, segment boundaries off the strip grid, 8192^2 at p=8,
   passes with 1 of p steps active, non-zero iteration offsets and halo
   values; every probe cell must stay Normal. The tile pass also runs, on
   every functor, interior tiles beside edge tiles whose core lies inside
   the grid, widths that are not multiples of 4, a ragged run, more tiles
   than resident CTAs and p=1; the line cache too, on every functor:
   interior panels beside edge panels at widths that are and are not
   multiples of 4, a ragged last strip, segments that end mid-strip or start
   inside another's warm-up, the law's strip and panel, p=1 and 1 of p
   steps active; the resident grid also, with HotSpot, Jacobi5 and the
   probe, at q = 1, 2 and 4 sub-steps per exchange with n*k not a multiple
   of q, on 8-row bands with a ragged last band, on 5-row and one-row bands
   (where the plan's q falls back to 1), and as a single CTA. The functors
   with a time-dependent value (TDV) run every one of these cases but the
   8192^2 ones: FDTD's three (coef, lut, render) on random fields and
   coefficients with a disk source that switches off, and detection that
   starts, inside the run; the probe whose TDV must equal the iteration, at
   radius 1 and 2 (the first radius-2 functor on the card), each also under
   every TDV strategy, with a stream shifted by one that must turn every
   cell Invalid. The six convection functors (pseudo-transient full and
   lean, thermal; float32 and float64: the first 8-byte cells and the first
   ten-variant-field, k=3 functors) run random fields and parameters with a
   halo of 0.5 on all three kernels: the mask rows nx-1, nx and columns
   ny-1, ny on tile, segment and band boundaries, odd shapes, an active
   region smaller than the grid, partial passes from an offset, the
   resident grid at q = 1 and 2; and n = nerr - 1 = 49 at p=2 through
   ``tiling`` in both window modes at 384x128, against ``reference``. The
   narrow-storage instantiations (bfloat16 HotSpot, Jacobi5 and FDTD coef,
   float8 e4m3 Jacobi5) run every case of the other functors' tile-pass,
   line-cache and band loops, exactly, NaN equal to NaN (widths 1001-1003
   leave a bfloat16 row that is not a whole number of 16-byte copies); and
   float8 overflow must come out NaN on every kernel as in the plain
   version. The tile pass in extended mode (a block at a global origin,
   with a stored halo; the multi-device backends' pass) runs HotSpot, the
   probe at radius 2, FDTD coef, convection's lean cell and Jacobi5 on
   bfloat16 on the nine shards of a 3x3 mesh (interior, edges, corners,
   negative origins, padding, odd widths, a stored halo wider than the
   pass's) and a ring chunk, with every step, 1 of p and no step active,
   exactly against its plain version;
4. drive the main paths through the entry points a user calls, each with
   the kernels' launch counters set to 0 just before it and read just
   after: ``hotspot.run(..., backend="auto")`` at 1024^2 (monotile) and
   8192^2 (tiling); ``jacobi.run`` of Jacobi5 at 8192^2 with
   ``backend="tiling", window_mode="linecache"`` (only the line-cache
   kernel) and through ``auto`` (tiling); Jacobi5 at 1024^2 through
   ``auto`` (monotile); Conway on a random 8192^2 soup through ``auto``;
   FDTD's mono-benchmark with its time axis cut (~8.2k iterations), coef
   1024^2 through ``auto`` (the tile pass, inline TDV), coef 512^2 through
   ``auto`` (the resident grid, host-precomputed TDV), render 1024^2
   through ``tiling(window_mode="linecache")`` (the line cache,
   device-precomputed TDV), lut 1024^2 through ``auto`` (the tile pass).
   Then hold each path against the plain ``reference`` backend at a
   reduced n (FDTD's also from an offset across the detect iteration).
   Last, FDTD coef 1024^2 through ``fdtd.run`` as a user calls it: three
   snapshots, paused and resumed through ``iteration_offset``, each writing
   an ``hz`` frame, which must equal one call of as many iterations.
   Then ``convection.run`` of the JAX bench's experiment (2 timesteps of at
   most 400 pseudo-transient iterations in blocks of 50): 3072x1024 in
   float32 and float64 through ``auto`` (the tile pass), 384x128 in float64
   through ``auto`` (the resident grid), 3072x1024 in float32 through
   ``tiling(window_mode="linecache")`` (the line cache); each path also runs
   one block and one thermal step against ``reference`` on the card,
   exactly, statistics included. Then the narrow paths the JAX bench's
   ``bf16_storage`` rows run, their cells cast with ``cast_storage`` and
   their kernels wrapped in ``CastStorageKernel``: Jacobi5 8192^2 in
   bfloat16 through ``auto`` (the tile pass, the bench's pinned
   ``jacobi_tiling_bf16``) and through ``tiling(window_mode="linecache")``
   (the line cache), HotSpot 8192^2 and FDTD coef 1024^2 in bfloat16
   through ``auto`` (the tile pass), Jacobi5 1024^2 in bfloat16 through
   ``auto`` (the resident grid), Jacobi5 8192^2 in float8 e4m3 through
   ``tiling``; each at a reduced n against ``reference``, exactly. Last,
   the multi-device paths on meshes whose positions all name the one card
   (:data:`MULTI_PATHS`): HotSpot 8192^2, n=200, through ``distributed`` on
   (2, 2) and (4, 1) at p=4 and p=8 and through ``ring`` of 4 at p=2;
   Jacobi5 8192^2 and FDTD coef 1024^2 through ``distributed`` (2, 2); the
   strong-scaling HotSpot 2048^2, n=256, on (1, 1), (2, 1), (2, 2) beside
   its ``auto`` run. Each launches the tile pass only, equals ``tiling``
   on the same grid bit for bit, and at a reduced n equals ``reference``
   and its ``local_compute="plain"`` run;
5. time the kernels, their plain versions and, where one exists, the
   PyTorch call that computes the same function, with CUDA events at the
   main paths' shapes and the config laws' geometry: the tile pass at
   HotSpot 8192^2, p=8, and at Conway 8192^2 (2 B a cell), each beside the
   line cache on the same pass in turns (tile pass, line cache, line cache,
   tile pass), so that the invariant-field and byte-cell paths have times;
   one Jacobi5 8192^2 pass of p=8 through the tile-pass and the line-cache
   kernels in turns, against p successive ``conv2d`` calls (cuDNN tuned by
   ``cudnn.benchmark``); the resident grid at HotSpot 1024^2, n=1000, with
   the same run through ``tiling`` and Jacobi5's 1024^2 run beside it. Also
   log how many tile-pass and line-cache CTAs the CUDA runtime keeps
   resident per SM against what the config laws counted. FDTD's kernels
   beside them: the tile pass on one pass of the coef 1024^2 path, the
   line cache on one pass of the render 1024^2 path, the resident grid on
   coef 512^2 at n=1000, each with its plain version (device time by
   ``torch.profiler``: a pass is shorter than its host call). The
   convection kernels at the four paths' shapes and geometry, one pass (the
   resident grid: one call) of each of their updates (lean, full, thermal),
   beside their plain versions and bounds (``convection kernels:`` line;
   float64 operations over 34 TFLOP/s). The bfloat16 kernels
   (:func:`narrow_kernel_rows`): one Jacobi5 8192^2 pass through the tile
   pass and the line cache in turns against p ``conv2d`` calls on bfloat16
   tensors, Jacobi5 1024^2 on the resident grid, and beside them HotSpot
   bf16, Jacobi5 float8 and FDTD coef bf16 passes. The tile pass in
   extended mode (:func:`extended_kernel_row`) on shard (0, 0) of HotSpot
   8192^2 on a (2, 2) and a (4, 1) mesh at p=4 and p=8, beside its plain
   version and the halo exchange of one pass;
6. the two kernels of the ``experiments/`` microbenchmarks
   (:func:`experiments_phase`): every variant of the strip kernel and of
   the line-cache kernel against its plain version, exactly; each entry
   point (``python -m stencilstream_tpu_torch.experiments.<script>``) once
   at its default configuration with few passes, and ``micro_linecache
   --check``; the kernels' times at each script's default workload.

The line before the last is a JSON object describing each kernel at one
workload that stays the same from run to run (tile pass: HotSpot 8192^2;
resident grid: HotSpot 1024^2; line cache: Jacobi5 8192^2), and each again
on bfloat16 cells (``<kernel>_bf16``: Jacobi5 8192^2 on the tile pass and
the line cache, Jacobi5 1024^2 on the resident grid), and the tile pass
in extended mode (``tile_pass_extended``: one pass of p=4 on shard (0, 0)
of HotSpot 8192^2 on a (2, 2) mesh; its launches those of the
multi-device paths), and one row for each TPU kernel of ``experiments/``
(``micro_strip/<script>``, ``micro_linecache/<script>``: the main paths
launch neither), with its bound:
the larger of the bytes it must move over 3.35 TB/s and its float32
operations (the transition function's ``n_operations``, a fused
multiply-add counted as two) over 67 TFLOP/s (H100 SXM at 700 W). The last
line is ``{"ok": true, "device": {...}}``. The port imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

#: HotSpot kernel against plain version, temperatures in [70, 90]: both
#: evaluate the same float32 operations in the same order, with the same
#: fused multiply-adds (explicit in both; the kernels are otherwise built
#: without FMA contraction), so they agree to a few ulps (an ulp at 80 is
#: 7.6e-6). 1e-4 admits that and nothing else: with the strong coefficients
#: below, one missing or extra iteration moves temperatures by ~1e-1, and a
#: wrong halo or coordinate by more.
ATOL = 1e-4
#: Jacobi, values in [0, 5] (random in [0, 1], halo 5.0): the same argument,
#: an ulp at 5 is 4.8e-7.
JACOBI_ATOL = 1e-5
#: The conv2d yardstick sums its five products in another order than the
#: kernels (and without their fused multiply-adds): a few ulps per step at
#: values in [0, 1] after p=8 steps.
LIBRARY_ATOL = 1e-5

#: FDTD kernel against plain version and against the reference backend:
#: exact. Both evaluate the same float32 operations in the same order, with
#: the same fused multiply-adds, and read one TDV stream; one missing or
#: extra source step moves hz at the source by the amplitude (~1).
FDTD_ATOL = 0.0

#: Convection kernel against plain version and against the reference
#: backend, float32 and float64: exact. Both evaluate the same operations in
#: the same order, with the same fused multiply-adds (``__fma_rn`` on the
#: card, an exact emulation in the plain version).
CONVECTION_ATOL = 0.0

#: Narrow storage (bfloat16, float8 e4m3) kernel against plain version and
#: against the reference backend: exact, a NaN equal to a NaN. Both compute
#: the same float32 operations and round each result to the storage type to
#: nearest even (float8 overflow to NaN).
NARROW_ATOL = 0.0
#: The bfloat16 conv2d yardstick against the plain version, values in
#: [0, 1]: cuDNN accumulates each call in float32 in its own order and
#: rounds once, the kernels round each multiply-add as the JAX package
#: does, so the two part by up to an ulp at 1 (2^-7) a step, p=8 steps.
LIBRARY_BF16_ATOL = 8 * 2.0 ** -7

#: (shape, q) of the resident grid's band checks: one-row bands, 8-row
#: bands with a ragged last band of 6 rows, 5-row bands.
MONO_BANDS = [((37, 53), 1), ((1030, 64), 1), ((1030, 64), 2), ((1030, 64), 4),
              ((600, 40), 1), ((600, 40), 2), ((600, 40), 4)]

#: The probes, whose cells must all stay Normal.
PROBES = ("probe", "probe_tdv", "probe_radius2")
#: The functors whose transition functions have a time-dependent value.
TDV_OPS = ["probe_tdv", "probe_radius2", "fdtd_coef", "fdtd_lut", "fdtd_render"]
#: The convection functors.
CONVECTION_OPS = [f"convection_{kind}_{width}" for kind in ("pt", "pt_lean", "thermal") for width in ("f32", "f64")]
#: Convection main paths: name -> the kernel each must launch alone.
CONVECTION_PATHS = {
    "convection f32 3072x1024 auto": "tile_pass",
    "convection f64 3072x1024 auto": "tile_pass",
    "convection f64 384x128 auto": "monotile",
    "convection f32 3072x1024 tiling linecache": "line_cache",
}

#: The narrow instantiations (csrc/ops/all.cuh: SS_FOR_EACH_NARROW_OP), by
#: their entry points' names.
NARROW_OPS = ["hotspot__bf16", "jacobi5_general__bf16", "fdtd_coef__bf16", "jacobi5_general__e4m3"]
#: Narrow main paths: name -> the kernel each must launch alone.
NARROW_PATHS = {
    "jacobi5 bf16 8192^2 auto": "tile_pass",
    "jacobi5 bf16 8192^2 tiling linecache": "line_cache",
    "hotspot bf16 8192^2 auto": "tile_pass",
    "fdtd coef bf16 1024^2 auto": "tile_pass",
    "jacobi5 bf16 1024^2 auto": "monotile",
    "jacobi5 e4m3 8192^2 tiling": "tile_pass",
}

#: The multi-device main paths (``trace_cells.multi_device_paths``), every
#: position of their meshes on the one card: each must launch the tile pass
#: only, equal ``tiling`` on the same grid at its full n bit for bit, and
#: equal ``reference`` and its plain local compute at a reduced n.
MULTI_PATHS = {
    "hotspot 8192^2 distributed 2x2": ATOL,
    "hotspot 8192^2 distributed 2x2 p=8": ATOL,
    "hotspot 8192^2 distributed 4x1": ATOL,
    "hotspot 8192^2 distributed 4x1 p=8": ATOL,
    "hotspot 8192^2 ring 4": ATOL,
    "jacobi5 8192^2 distributed 2x2": JACOBI_ATOL,
    "fdtd coef 1024^2 distributed 2x2": FDTD_ATOL,
    "hotspot 2048^2 distributed 1x1": ATOL,
    "hotspot 2048^2 distributed 2x1": ATOL,
    "hotspot 2048^2 distributed 2x2": ATOL,
}
#: The tile pass's extended mode: functor -> p (``tests/test_torch_kernels.py``
#: holds the same cases): HotSpot (an invariant field), the probe at radius
#: 2 with its TDV, FDTD coef with its TDV, convection's lean cell and
#: Jacobi5 on bfloat16 cells.
EXTENDED_OPS = {"hotspot": 4, "probe_radius2": 2, "fdtd_coef": 2, "convection_pt_lean_f32": 2,
                "jacobi5_general__bf16": 4}

JACOBI_COEFS = {
    "jacobi1_general": [0.9],
    "jacobi4_general": [0.1, 0.2, 0.3, 0.4],
    "jacobi5_general": [0.15, 0.2, 0.25, 0.1, 0.3],
    "jacobi9_general": [0.05, 0.1, 0.15, 0.2, 0.02, 0.13, 0.07, 0.11, 0.17],
}


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip()


def hotspot_cell(shape, seed, device):
    from stencilstream_tpu_torch.models.hotspot import HotspotCell
    import torch

    rng = np.random.default_rng(seed)
    return HotspotCell(
        temp=torch.tensor(rng.uniform(70, 90, shape).astype(np.float32), device=device),
        power=torch.tensor(rng.uniform(0, 1e-3, shape).astype(np.float32), device=device),
    )


def fdtd_case(resolver, shape, rng, device, iteration):
    """FDTD with random fields and random coefficients (the coef cells', the
    lut indices, some outside the table, and the lut and render tables), a
    disk source of radius 3 cells at the grid's centre that switches off two
    iterations after ``iteration``, detection from the one after it, and a
    non-zero halo (the lut index's halo 3)."""
    import dataclasses

    import torch

    from stencilstream_tpu_torch.models import fdtd

    h, w = shape
    p = fdtd.Parameters.from_json(fdtd.mono_benchmark(20))
    res = fdtd.RESOLVERS[resolver](p)
    tf = fdtd.make_kernel(p, res)
    sr, sc = h // 2, w // 2
    state = tf.resolver_state
    if state is not None:
        state = {**state, **{f: rng.uniform(0, 1, 16).astype(np.float32) for f in ("ca", "cb", "da", "db")}}
        if "bounds" in state:
            state["bounds"] = np.sort(rng.uniform(-h * h / 2, 0, 16)).astype(np.float32)
    tf = dataclasses.replace(
        tf, source_r=np.float32(sr), source_c=np.float32(sc), source_radius_squared=9.0,
        source_distance_bound=np.float32(9 - sr * sr - sc * sc), double_center_rc=np.float32(h),
        cutoff_iteration=iteration + 2, detect_iteration=iteration + 1, resolver_state=state,
    )
    fields = {f.name: torch.tensor(rng.uniform(-1, 1, shape).astype(np.float32), device=device)
              for f in dataclasses.fields(res.MaterialCell)}
    halo = dict(ex=0.25, ey=-0.5, hz=0.75, hz_sum=1.0)
    if resolver == "lut":
        fields["index"] = torch.tensor(rng.integers(-1, 17, shape).astype(np.int32), device=device)
        halo["index"] = 3
    if resolver == "coef":
        halo.update(ca=0.5, cb=0.125, da=0.5, db=0.125)
    return res.MaterialCell(**fields), tf, res.MaterialCell(**halo), FDTD_ATOL


def convection_case(op, shape, rng, device, active=None):
    """``tile_sweep.convection_case`` (random fields and parameters, a halo
    of 0.5) with the tolerance."""
    from stencilstream_tpu_torch.tile_sweep import convection_case as case

    return (*case(op, shape, rng, device, active), CONVECTION_ATOL)


def op_case(op, shape, seed, device, iteration=0):
    """(cell, transition function, halo cell, tolerance) for a device
    functor: non-zero halos (HotSpot 5.0 and 0.25 for the power, Jacobi
    5.0, FDTD's :func:`fdtd_case`); the probes' cells sit at
    ``iteration``. A narrow instantiation, ``<functor>__<storage>``, gets
    the functor's case with its float32 fields cast to the storage type
    and its transition function wrapped (``CastStorageKernel``)."""
    import torch

    from stencilstream_tpu_torch import probe
    from stencilstream_tpu_torch.backends.cuda_lib import STORAGE_SUFFIX
    from stencilstream_tpu_torch.backends.storage_cast import CastStorageKernel, cast_storage
    from stencilstream_tpu_torch.models import conway, hotspot, jacobi

    functor, _, suffix = op.partition("__")
    if suffix:
        (storage,) = [d for d, s in STORAGE_SUFFIX.items() if s == suffix]
        cell, tf, halo, _ = op_case(functor, shape, seed, device, iteration)
        return cast_storage(cell, storage), CastStorageKernel(tf, storage), halo, NARROW_ATOL
    rng = np.random.default_rng(seed)
    if op == "hotspot":
        strong = hotspot.HotspotKernel(
            Rx_1=np.float32(0.1), Ry_1=np.float32(0.1), Rz_1=np.float32(0.05), Cap_1=np.float32(0.5)
        )
        return hotspot_cell(shape, seed, device), strong, hotspot.HotspotCell(temp=5.0, power=0.25), ATOL
    if op in jacobi.VARIANTS:
        x = torch.tensor(rng.random(shape, np.float32), device=device)
        return x, jacobi.make_kernel(op, JACOBI_COEFS.get(op, [])), 5.0, JACOBI_ATOL
    if op == "conway":
        return torch.tensor(rng.random(shape) < 0.4, device=device), conway.ConwayKernel(), False, 0.0
    if op.startswith("fdtd_"):
        return fdtd_case(op[len("fdtd_"):], shape, rng, device, iteration)
    if op.startswith("convection_"):
        return convection_case(op, shape, rng, device)
    grid = probe.make_probe_grid(*shape, iteration, device=device)
    if op in ("probe_tdv", "probe_radius2"):
        tf = probe.ProbeTransFunc(radius_=1 if op == "probe_tdv" else 2)
        return grid.arrays, tf, probe.probe_halo_cell(), 0.0
    return grid.arrays, probe.ProbeKernel(), probe.probe_halo_cell(), 0.0


def max_err(a, b) -> float:
    """Largest absolute difference of two cells' fields; a NaN on one side
    only counts as an infinite difference, NaN on both as none."""
    import torch

    from stencilstream_tpu_torch.core.cell import cell_leaves

    def err(x, y):
        x, y = x.double(), y.double()
        d = (x - y).abs().nan_to_num(nan=float("inf"))
        return float(torch.where(x.isnan() & y.isnan(), 0.0, d).max())

    return max(err(x, y) for x, y in zip(cell_leaves(a), cell_leaves(b)))


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls, by CUDA events."""
    import torch

    fn()  # warm up
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(n_bytes: float, n_flops: float, wide: bool = False) -> tuple[float, str]:
    """The least time, in ms, the card could take: the larger of the bytes
    over HBM's rate and the operations over the card's float32 peak (its
    float64 peak if ``wide``), by the port's one table of H100 rates."""
    from stencilstream_tpu_torch.experiments.common import FP32_FLOP_PER_S, FP64_FLOP_PER_S, bound_ms

    return bound_ms(n_bytes, n_flops, FP64_FLOP_PER_S if wide else FP32_FLOP_PER_S)


def library_jacobi(y, steps):
    """``steps`` Jacobi5 iterations of the JAX bench's coefficients at halo
    0 as ``conv2d`` calls on ``y``'s dtype: the PyTorch yardstick."""
    import torch

    from stencilstream_tpu_torch.trace_cells import JACOBI5_COEFS

    c = JACOBI5_COEFS
    w = torch.tensor([[0, c[0], 0], [c[1], c[4], c[3]], [0, c[2], 0]], dtype=y.dtype, device=y.device)
    w, y = w.view(1, 1, 3, 3), y.view(1, 1, *y.shape)
    for _ in range(steps):
        y = torch.nn.functional.conv2d(y, w, padding=1)
    return y.view(y.shape[2:])


def in_turns(cell, tf, halo, tile, p, limits, reps) -> dict:
    """One pass of p from iteration 0 through the tile-pass kernel at
    ``tile`` and the line-cache kernel at its law's geometry for this cell,
    timed in turns (tile pass, line cache, line cache, tile pass) on the same
    input: the geometry and each kernel's times and result."""
    from stencilstream_tpu_torch.backends import cuda_lib
    from stencilstream_tpu_torch.backends import line_cache as lc
    from stencilstream_tpu_torch.backends import tile_pass as tp
    from stencilstream_tpu_torch.core.cell import cell_leaves

    H, W = cell_leaves(cell)[0].shape
    cfg = lc.pick_linecache_config(H, W, tf.stencil_radius, tf.n_subiterations, p,
                                   *cuda_lib.cell_field_bytes(cell, tf), limits, iters_per_pass=p)
    geometry = {k: getattr(cfg, k) for k in ("strip_rows", "panel_cols", "segment_rows")}
    kw = dict(i_start=0, offset=0, n_iterations=p, iters_per_pass=p)
    runs = {"tile_pass": lambda: tp.tile_pass(cell, tf, halo, tile=tile, **kw),
            "line_cache": lambda: lc.line_cache_pass(cell, tf, halo, **geometry, **kw)}
    times = {k: [] for k in runs}
    for k in ("tile_pass", "line_cache", "line_cache", "tile_pass"):
        times[k].append(cuda_ms(runs[k], reps))
    return dict(geometry=geometry, times=times, ms={k: sum(v) / len(v) for k, v in times.items()},
                out={k: run() for k, run in runs.items()})


def check(errs, kernel, what, got, want, tol, moved=None) -> None:
    e = max_err(got, want)
    errs[kernel] = max(errs[kernel], e)
    note = f"; the run moved cells by up to {moved:.3g}" if moved is not None else ""
    log(f"  {kernel} {what}: max_abs_err={e:.3g} (tol {tol}{note})")
    assert e <= tol, f"{kernel} kernel disagrees with its plain version ({what}): {e}"


def check_tdv_probes(device, errs) -> None:
    """Phase 3, the TDV probes under every strategy: a call of n=5 from
    iteration 3; the tile pass and the line cache on its second pass of p=4
    (1 of 4 steps active), the resident grid at q = 1, 2 and 4 on 8-row
    bands. Every cell Normal; a stream shifted by one turns every cell
    Invalid."""
    import torch

    from stencilstream_tpu_torch import probe
    from stencilstream_tpu_torch.backends import line_cache as lc
    from stencilstream_tpu_torch.backends.monotile import MAX_THREADS, MonotilePlan, monotile, monotile_plain
    from stencilstream_tpu_torch.backends.tile_pass import tile_pass, tile_pass_plain
    from stencilstream_tpu_torch.tdv import tdv_stream

    for seed, op in enumerate(("probe_tdv", "probe_radius2"), start=700):
        for strategy in ("inline", "precompute_on_device", "precompute_on_host"):
            cell, tf, halo, tol = op_case(op, (45, 70), seed, device, iteration=7)
            stream = tdv_stream(tf, 3, 5, device, strategy)
            assert stream.tolist() == [3, 4, 5, 6, 7], stream
            kw = dict(i_start=7, offset=3, n_iterations=5, iters_per_pass=4, tdv=stream)
            want = tile_pass_plain(cell, tf, halo, **kw)
            runs = {"tile_pass": lambda: tile_pass(cell, tf, halo, tile=(16, 32), **kw),
                    "line_cache": lambda: lc.line_cache_pass(cell, tf, halo, strip_rows=8, panel_cols=32,
                                                             segment_rows=20, **kw)}
            for kernel, run in runs.items():
                got = run()
                torch.cuda.synchronize()
                check(errs, kernel, f"{op} {strategy} (45, 70) p=4 i_start=7 offset=3 n=5", got, want, tol)
                assert int(got.status.abs().max()) == probe.NORMAL, "probe cells flagged Invalid"
            kw["tdv"] = stream + 1
            shifted = tile_pass(cell, tf, halo, tile=(16, 32), **kw)
            assert bool((shifted.status == probe.INVALID).all()), "a shifted TDV stream went unseen"
            check(errs, "tile_pass", f"{op} {strategy} shifted stream", shifted,
                  tile_pass_plain(cell, tf, halo, **kw), tol)
            cell, tf, halo, tol = op_case(op, (1030, 64), seed, device, iteration=3)
            stream = tdv_stream(tf, 3, 3, device, strategy)
            want = monotile_plain(cell, tf, halo, offset=3, n_iterations=3, tdv=stream)
            for q in (1, 2, 4):
                plan = MonotilePlan(8, -(-1030 // 8), 0, q, MAX_THREADS)
                got = monotile(cell, tf, halo, offset=3, n_iterations=3, tdv=stream, plan=plan)
                torch.cuda.synchronize()
                check(errs, "monotile", f"{op} {strategy} (1030, 64) band=8 q={q} offset=3 n=3", got, want, tol)
                assert int(got.status.abs().max()) == probe.NORMAL, "probe cells flagged Invalid"


def check_convection(device, errs) -> None:
    """Phase 3, the convection functors on all three kernels, exactly: the
    mask rows nx-1, nx and columns ny-1, ny on the boundaries of 16x32 tile
    cores, of 16-row segments and of 8-row bands (33x65, active 32x64), an
    odd shape (45x70), an active region smaller than the grid (40x72,
    active 32x64); the tile pass and the line cache on both passes of p=2
    of a call of n=5 from 1; the resident grid at q = 1 and 2 on 8-row
    bands and at the plan's geometry. Then n = nerr - 1 = 49 at p=2 through
    ``tiling`` in both window modes from iteration 7 at 384x128, against
    the reference backend; and each functor with NaN in the invariant fields
    it does not read."""
    import dataclasses

    import torch

    from stencilstream_tpu_torch import Grid, Params, create_update
    from stencilstream_tpu_torch.backends import cuda_lib
    from stencilstream_tpu_torch.backends import line_cache as lc
    from stencilstream_tpu_torch.backends.monotile import MAX_THREADS, MonotilePlan, monotile, monotile_plain
    from stencilstream_tpu_torch.models import convection
    from stencilstream_tpu_torch.backends.tile_pass import tile_pass, tile_pass_plain

    shapes = [((33, 65), (32, 64)), ((45, 70), (44, 69)), ((40, 72), (32, 64))]
    for seed, op in enumerate(CONVECTION_OPS, start=800):
        for shape, active in shapes:
            cell, tf, halo, tol = convection_case(op, shape, np.random.default_rng(seed), device, active)
            strip = 16 if "thermal" in op else 8
            for i_start in (1, 3):
                kw = dict(i_start=i_start, offset=1, n_iterations=5, iters_per_pass=2)
                want = tile_pass_plain(cell, tf, halo, **kw)
                got = tile_pass(cell, tf, halo, tile=(16, 32), **kw)
                torch.cuda.synchronize()
                check(errs, "tile_pass", f"{op} {shape} active {active} tile=(16, 32) p=2 i_start={i_start} "
                      f"offset=1 n=5", got, want, tol)
                got = lc.line_cache_pass(cell, tf, halo, strip_rows=strip, panel_cols=32, segment_rows=16, **kw)
                torch.cuda.synchronize()
                check(errs, "line_cache", f"{op} {shape} active {active} strip={strip} panel=32 segment=16 p=2 "
                      f"i_start={i_start} offset=1 n=5", got, want, tol)
            want = monotile_plain(cell, tf, halo, offset=1, n_iterations=3)
            for q in (1, 2, None):
                plan = MonotilePlan(8, -(-shape[0] // 8), 0, q, MAX_THREADS) if q else None
                got = monotile(cell, tf, halo, offset=1, n_iterations=3, plan=plan)
                torch.cuda.synchronize()
                check(errs, "monotile", f"{op} {shape} active {active} " + (f"band=8 q={q}" if q else "plan")
                      + " offset=1 n=3", got, want, tol)
        cell, tf, halo, tol = convection_case(op, (384, 128), np.random.default_rng(seed), device)
        grid = Grid(cell)

        def update(backend, **kw):
            return create_update(Params(tf, halo_value=halo, iteration_offset=7, n_iterations=49), backend=backend,
                                 **kw)

        want = update("reference")(grid)
        for kernel, kw in (("tile_pass", {}), ("line_cache", {"window_mode": "linecache"})):
            got = update("tiling", iters_per_pass=2, **kw)(grid)
            check(errs, kernel, f"{op} (384, 128) tiling {kw} p=2 offset=7 n=49 against reference", got.arrays,
                  want.arrays, tol)
    # The invariant fields a functor does not read (cuda_invariant_reads,
    # which the bounds count on) can hold NaN without changing a cell.
    for seed, op in enumerate(CONVECTION_OPS, start=820):
        cell, tf, halo, tol = convection_case(op, (33, 65), np.random.default_rng(seed), device)
        kw = dict(i_start=0, offset=0, n_iterations=2, iters_per_pass=2)
        want = tile_pass_plain(cell, tf, halo, **kw)
        unread = [f for f in convection.FIELDS if f not in tf.cuda_variant and f not in tf.cuda_invariant_reads]
        poisoned = dataclasses.replace(cell, **{f: torch.full_like(getattr(cell, f), float("nan")) for f in unread})
        got = tile_pass(poisoned, tf, halo, tile=(16, 32), **kw)
        torch.cuda.synchronize()
        got = dataclasses.replace(got, **{f: getattr(cell, f) for f in unread})  # the inputs, passed through
        check(errs, "tile_pass", f"{op} (33, 65) with NaN in its unread fields {unread}", got, want, tol)
    limits = cuda_lib.device_limits(device)
    log(f"  convection cell bytes in shared memory: " + ", ".join(
        f"{op} {cuda_lib.cell_smem_bytes(*convection_case(op, (2, 2), np.random.default_rng(0), 'cpu')[:2])} B"
        for op in CONVECTION_OPS) + f" (limits {limits})")


def check_float8_overflow(device, errs) -> None:
    """Phase 3, float8 overflow: Jacobi5 in float8 e4m3 with coefficients
    summing to 2.5 on values in [20, 260] and in [10, 150] must come out NaN
    where the plain version does (not saturated to 448), on all three
    kernels."""
    import torch

    from stencilstream_tpu_torch.backends import line_cache as lc
    from stencilstream_tpu_torch.backends.monotile import monotile
    from stencilstream_tpu_torch.backends.storage_cast import CastStorageKernel, cast_storage
    from stencilstream_tpu_torch.backends.tile_pass import tile_pass, tile_pass_plain
    from stencilstream_tpu_torch.models import jacobi

    # Values in [20, 260] overflow on the first step (the second reads NaN),
    # in [10, 150] on the second (beside results that round to 448).
    e4m3 = torch.float8_e4m3fn
    tf = CastStorageKernel(jacobi.make_kernel("jacobi5_general", [0.5] * 5), e4m3)
    kw = dict(i_start=0, offset=0, n_iterations=2, iters_per_pass=2)
    for lo, hi in ((20, 260), (10, 150)):
        x = torch.tensor(np.random.default_rng(950).uniform(lo, hi, (96, 160)).astype(np.float32), device=device)
        cell = cast_storage(x, e4m3)
        want = tile_pass_plain(cell, tf, 1.0, **kw)
        n_nan = int(want.float().isnan().sum())
        assert 0 < n_nan < want.numel(), n_nan
        runs = {"tile_pass": lambda: tile_pass(cell, tf, 1.0, tile=(32, 64), **kw),
                "line_cache": lambda: lc.line_cache_pass(cell, tf, 1.0, strip_rows=16, panel_cols=64,
                                                         segment_rows=32, **kw),
                "monotile": lambda: monotile(cell, tf, 1.0, offset=0, n_iterations=2)}
        for kernel, run in runs.items():
            got = run()
            torch.cuda.synchronize()
            check(errs, kernel, f"jacobi5_general float8_e4m3fn overflow, values in [{lo}, {hi}], (96, 160) n=2: "
                  f"{n_nan} NaN cells", got, want, NARROW_ATOL)


def check_extended(device, errs) -> None:
    """Phase 3, the tile pass in extended mode against its plain version,
    exactly: each functor of :data:`EXTENDED_OPS` on the nine shards of a
    3x3 mesh of 20x61 cores (interior, edge and corner shards, negative
    origins, padding past the grid, odd block widths, a stored halo wider
    than the pass's) and on a ring chunk, for a pass with every step, 1 of
    p and no step active. Probe cells carry global coordinates; those in the
    grid must stay Normal."""
    import dataclasses

    import torch

    from stencilstream_tpu_torch import probe
    from stencilstream_tpu_torch.backends.tile_pass import tile_pass, tile_pass_plain
    from stencilstream_tpu_torch.tile_sweep import extended_blocks

    for seed, (op, p) in enumerate(EXTENDED_OPS.items(), start=900):
        tf = op_case(op, (2, 2), 0, "cpu")[1]
        hp = tf.stencil_radius * p * tf.n_subiterations
        for steps, (i_start, offset, n) in {"all": (3, 3, 2 * p), "one": (3 + p, 3, p + 1),
                                            "none": (3 + 2 * p, 3, 2 * p)}.items():
            for label, shape, origin, grid_range, stored in extended_blocks((20, 61), hp):
                cell, tf, halo, tol = op_case(op, shape, seed, device, iteration=i_start)
                if op in PROBES:
                    cell = dataclasses.replace(cell, r=cell.r + origin[0], c=cell.c + origin[1])
                kw = dict(i_start=i_start, offset=offset, n_iterations=n, iters_per_pass=p, origin=origin,
                          grid_range=grid_range, stored_halo=stored)
                got = tile_pass(cell, tf, halo, tile=(16, 32), **kw)
                want = tile_pass_plain(cell, tf, halo, **kw)
                torch.cuda.synchronize()
                e = max_err(got, want)
                errs["tile_pass_extended"] = max(errs["tile_pass_extended"], e)
                assert e == 0, f"extended tile pass disagrees with its plain version: {op} {label} {steps}: {e}"
                if op in PROBES:
                    h, w = shape[0] - 2 * stored[0], shape[1] - 2 * stored[1]
                    rows = torch.arange(h, device=device) + origin[0] + stored[0]
                    cols = torch.arange(w, device=device) + origin[1] + stored[1]
                    inside = ((rows >= 0) & (rows < grid_range[0]))[:, None] & \
                        ((cols >= 0) & (cols < grid_range[1]))[None, :]
                    assert bool((got.status[inside] == probe.NORMAL).all()), (op, label, steps)
            log(f"  tile_pass_extended {op} p={p}, {steps} steps active, 10 blocks (3x3 shards of 20x61 cores, "
                f"stored halo {hp}+(1, 3), and a ring chunk): max_abs_err={errs['tile_pass_extended']:.3g} (tol 0)")


def check_kernels(device) -> dict:
    """Phase 3: each kernel against its plain version on the card."""
    import torch

    from stencilstream_tpu_torch import probe
    from stencilstream_tpu_torch.backends import line_cache as lc
    from stencilstream_tpu_torch.backends.monotile import (
        MAX_THREADS, MonotilePlan, monotile, monotile_plain, monotile_plan,
    )
    from stencilstream_tpu_torch.backends import cuda_lib
    from stencilstream_tpu_torch.backends.tile_pass import tile_pass, tile_pass_plain, tile_smem_bytes
    from stencilstream_tpu_torch.models import jacobi

    errs = {"tile_pass": 0.0, "monotile": 0.0, "line_cache": 0.0, "tile_pass_extended": 0.0}
    # HotSpot, (shape, tile, iters_per_pass, i_start, offset, n): partial
    # passes, non-zero offsets, odd shapes and a grid smaller than one tile.
    tile_cases = [
        ((37, 53), (16, 32), 3, 3, 3, 5),
        ((37, 53), (64, 64), 4, 7, 3, 5),     # second pass: 1 of 4 steps
        ((20, 24), (64, 64), 8, 0, 0, 8),     # grid smaller than a tile
        ((1000, 1000), (64, 64), 8, 11, 10, 13),
        ((1000, 1000), (32, 64), 6, 5, 5, 100),
        ((8192, 8192), (64, 64), 8, 0, 0, 1000),
    ]
    for seed, (shape, tile, p, i_start, offset, n) in enumerate(tile_cases):
        cell, tf, halo, tol = op_case("hotspot", shape, seed, device)
        kw = dict(i_start=i_start, offset=offset, n_iterations=n, iters_per_pass=p)
        got = tile_pass(cell, tf, halo, tile=tile, **kw)
        want = tile_pass_plain(cell, tf, halo, **kw)
        torch.cuda.synchronize()
        check(errs, "tile_pass", f"hotspot {shape} tile={tile} p={p} i_start={i_start} offset={offset} "
              f"n={n}", got, want, tol, max_err(want, cell))
        assert got.power is cell.power, "invariant field must be passed through"
    # HotSpot on the resident grid at the plan's geometry, (shape, offset,
    # n): at (37, 53) the one-row bands force q down to 1.
    limits = cuda_lib.device_limits(device)
    mono_cases = [((37, 53), 3, 7), ((20, 24), 0, 1), ((1000, 1000), 5, 64), ((1024, 1024), 2, 200)]
    for seed, (shape, offset, n) in enumerate(mono_cases, start=100):
        cell, tf, halo, tol = op_case("hotspot", shape, seed, device)
        plan = monotile_plan(*shape, 1, 12, limits)
        got = monotile(cell, tf, halo, offset=offset, n_iterations=n)
        want = monotile_plain(cell, tf, halo, offset=offset, n_iterations=n)
        torch.cuda.synchronize()
        check(errs, "monotile", f"hotspot {shape} offset={offset} n={n} band={plan.band} q={plan.q} "
              f"threads={plan.threads}", got, want, tol, max_err(want, cell))
    # The resident grid's band algebra at a given q, one CTA of 1024 threads
    # an SM, from iteration 3 with n*k not a multiple of q (but for the k=2
    # functors at q=2), so the last group is short: 8-row bands with a
    # ragged last band of 6 rows (1030), 5-row bands (600), one-row bands
    # (37), but none with q*r beyond the band; every probe cell must stay
    # Normal. Then a single CTA that holds the whole grid, q=4, from
    # iteration 2.
    for seed, op in enumerate(["hotspot", "jacobi5_general", "probe", *TDV_OPS, *NARROW_OPS], start=600):
        for shape, q in MONO_BANDS:
            cell, tf, halo, tol = op_case(op, shape, seed, device, iteration=3)
            n = 3 if tf.n_subiterations == 2 else 5
            band = -(-shape[0] // limits.sm_count)
            if q * tf.stencil_radius > band:
                continue
            plan = MonotilePlan(band, -(-shape[0] // band), 0, q, MAX_THREADS)
            got = monotile(cell, tf, halo, offset=3, n_iterations=n, plan=plan)
            want = monotile_plain(cell, tf, halo, offset=3, n_iterations=n)
            torch.cuda.synchronize()
            check(errs, "monotile", f"{op} {shape} band={band} q={q} offset=3 n={n}", got, want, tol)
            if op in PROBES:
                assert int(got.status.abs().max()) == probe.NORMAL, "probe cells flagged Invalid"
        cell, tf, halo, tol = op_case(op, (37, 53), seed, device, iteration=2)
        plan = MonotilePlan(37, 1, 0, 4, MAX_THREADS)
        got = monotile(cell, tf, halo, offset=2, n_iterations=7, plan=plan)
        want = monotile_plain(cell, tf, halo, offset=2, n_iterations=7)
        torch.cuda.synchronize()
        check(errs, "monotile", f"{op} (37, 53) one CTA q=4 offset=2 n=7", got, want, tol)
        if op in PROBES:
            assert int(got.status.abs().max()) == probe.NORMAL, "probe cells flagged Invalid"

    check_extended(device, errs)
    check_tdv_probes(device, errs)
    check_convection(device, errs)
    check_float8_overflow(device, errs)

    # Every other functor on every kernel.
    others = [*sorted(jacobi.VARIANTS), "conway", "probe", *TDV_OPS, *NARROW_OPS]
    for seed, op in enumerate(others, start=200):
        # 600^2: the probe's 40 B a cell still fit the resident grid there.
        for shape in ((45, 70), (600, 600)):
            cell, tf, halo, tol = op_case(op, shape, seed, device, iteration=1)
            kw = dict(i_start=1, offset=1, n_iterations=5, iters_per_pass=3)
            got = tile_pass(cell, tf, halo, tile=(16, 32), **kw)
            want = tile_pass_plain(cell, tf, halo, **kw)
            torch.cuda.synchronize()
            check(errs, "tile_pass", f"{op} {shape} tile=(16, 32) p=3 i_start=1 offset=1 n=5",
                  got, want, tol)
            got = lc.line_cache_pass(cell, tf, halo, strip_rows=8, panel_cols=32, segment_rows=20, **kw)
            torch.cuda.synchronize()
            check(errs, "line_cache", f"{op} {shape} strip=8 panel=32 segment=20 p=3 i_start=1 "
                  f"offset=1 n=5", got, want, tol)
            got = monotile(cell, tf, halo, offset=1, n_iterations=4)
            want = monotile_plain(cell, tf, halo, offset=1, n_iterations=4)
            torch.cuda.synchronize()
            check(errs, "monotile", f"{op} {shape} offset=1 n=4", got, want, tol)
            if op in PROBES:
                assert int(got.status.abs().max()) == probe.NORMAL, "probe cells flagged Invalid"

    # The tile-pass kernel's geometry on every functor, (shape, tile,
    # iters_per_pass, i_start, offset, n): interior tiles beside edge tiles
    # whose core lies inside the grid but whose window does not; widths that
    # are not multiples of 4 (the copy widths); a window height that leaves
    # a ragged run; more tiles than resident CTAs; p=1; 1 of p steps active.
    # p, then the core's height, halves until the window fits one block.
    geometry_cases = [
        ((192, 288), (64, 96), 8, 0, 0, 8),
        ((61, 1001), (32, 64), 3, 2, 1, 20),
        ((70, 1002), (20, 32), 8, 0, 0, 8),
        ((1000, 1003), (8, 32), 2, 0, 0, 2),
        ((45, 70), (16, 32), 1, 4, 4, 1),
        ((45, 70), (16, 32), 4, 7, 3, 5),
    ]
    for seed, op in enumerate(["hotspot", *others], start=400):
        for shape, tile, p, i_start, offset, n in geometry_cases:
            cell, tf, halo, tol = op_case(op, shape, seed, device, iteration=i_start)
            cell_bytes = cuda_lib.cell_smem_bytes(cell, tf)
            while tile_smem_bytes(*tile, tf.stencil_radius * p * tf.n_subiterations, cell_bytes) > \
                    limits.smem_per_block:
                tile, p = (tile, p // 2) if p > 1 else ((max(8, tile[0] // 2), tile[1]), p)
            kw = dict(i_start=i_start, offset=offset, n_iterations=n, iters_per_pass=p)
            got = tile_pass(cell, tf, halo, tile=tile, **kw)
            want = tile_pass_plain(cell, tf, halo, **kw)
            torch.cuda.synchronize()
            check(errs, "tile_pass", f"{op} {shape} tile={tile} p={p} i_start={i_start} offset={offset} "
                  f"n={n}", got, want, tol)
            if op in PROBES:
                assert int(got.status.abs().max()) == probe.NORMAL, "probe cells flagged Invalid"

    # The line-cache kernel's geometry on every functor, (shape, strip,
    # panel, segment, iters_per_pass, i_start, offset, n): interior panels
    # beside edge panels at widths that are and are not multiples of 4; a
    # ragged last strip; segments that end mid-strip, and segments shorter
    # than the warm-up, so that each starts inside the warm-up of the one
    # below; the law's strip and panel; p=1; 1 of p steps active. p, then the
    # panel, shrink until the CTA fits one block.
    law = lc.pick_linecache_config(8192, 8192, 1, 1, 8, 4, 0, limits)  # Jacobi5's
    line_geometry = [
        ((203, 1001), 32, 112, 64, 8, 0, 0, 8),
        ((200, 1008), 32, 112, 100, 8, 2, 1, 20),
        ((150, 1000), 64, 48, 20, 8, 0, 0, 8),
        ((300, 260), law.strip_rows, law.panel_cols, 128, 8, 0, 0, 8),
        ((45, 70), 8, 32, 16, 1, 4, 4, 1),
        ((45, 70), 16, 48, 24, 4, 7, 3, 5),
    ]
    def check_line(op, seed, shape, strip, panel, segment, p, i_start, offset, n):
        cell, tf, halo, tol = op_case(op, shape, seed, device, iteration=i_start)
        variant, invariant = cuda_lib.cell_field_bytes(cell, tf)
        while lc.line_cache_smem_bytes(strip, panel, tf.stencil_radius, p * tf.n_subiterations, variant,
                                       invariant) > limits.smem_per_block:
            p, panel = (p // 2, panel) if p > 1 else (p, max(32, panel - 32))
        kw = dict(i_start=i_start, offset=offset, n_iterations=n, iters_per_pass=p)
        got = lc.line_cache_pass(cell, tf, halo, strip_rows=strip, panel_cols=panel, segment_rows=segment, **kw)
        want = lc.line_cache_pass_plain(cell, tf, halo, **kw)
        torch.cuda.synchronize()
        check(errs, "line_cache", f"{op} {shape} strip={strip} panel={panel} segment={segment} "
              f"p={p} i_start={i_start} offset={offset} n={n}", got, want, tol)
        if op.partition("__")[0] == "hotspot":
            assert got.power is cell.power, "invariant field must be passed through"
        if op in PROBES:
            assert int(got.status.abs().max()) == probe.NORMAL, "probe cells flagged Invalid"

    for seed, op in enumerate(["hotspot", *others], start=500):
        for case in line_geometry:
            check_line(op, seed, *case)

    # The line-cache kernel on the four cell kinds, (shape, strip, panel,
    # segment, iters_per_pass, i_start, offset, n), up to 8192^2 at p=8 and
    # the law's geometry.
    big = lc.pick_linecache_config(8192, 8192, 1, 1, 1000, 4, 0, limits)
    line_cases = [
        ((37, 53), 8, 32, 16, 3, 3, 3, 5),
        ((37, 53), 32, 64, 64, 4, 7, 3, 5),        # 1 of 4 steps active
        ((20, 24), 32, 64, 32, 8, 0, 0, 8),        # smaller than a strip and a panel
        ((1000, 1000), 32, 64, 100, 8, 11, 10, 13),  # segments off the strip grid
        ((1000, 1000), 32, 64, 128, 8, 5, 5, 100),
        ((8192, 8192), big.strip_rows, big.panel_cols, big.segment_rows, 8, 0, 0, 1000),
    ]
    for op in ("hotspot", "jacobi5_general", "conway", "probe"):
        for seed, case in enumerate(line_cases, start=300):
            check_line(op, seed, *case)
    return errs


def fdtd_user_run(path, counters, card, side: int = 1024) -> tuple[dict, float]:
    """Phase 4, FDTD coef side^2 as a user runs it: ``fdtd.run`` with its
    snapshot loop (calls of n_snap iterations resumed through
    iteration_offset, each writing an hz frame into a temporary directory
    under the package's build directory), the inline TDV, through auto. It
    must launch the tile pass only and end where one call of as many
    iterations of ``path`` (the main path's run) ends. Returns the launch
    counts and that difference."""
    from stencilstream_tpu_torch.backends import cuda_lib
    from stencilstream_tpu_torch.models import fdtd

    parameters = fdtd.Parameters.from_json(fdtd.mono_benchmark(side))
    cuda_lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cuda_lib.BUILD_DIR) as frames:
        parameters.out_dir = frames
        for module in counters.values():
            module.launches = 0
        out, update = fdtd.run(parameters, backend="auto", device=path[0].device)
        counts = {k: m.launches for k, m in counters.items()}
        n_frames = len(os.listdir(frames))
    n_snap = parameters.n_snap_timesteps()
    n_run = -(-parameters.n_timesteps() // n_snap) * n_snap
    log(f"  fdtd.run coef {side}^2 auto, {n_run} iterations in {n_frames} snapshots of {n_snap}: -> "
        f"{getattr(update, 'resolved_backend', 'tiling')} {update.resolved_config}; launches {counts}; walltime "
        f"{update.get_walltime():.6f} s, {side * side * n_run / update.get_walltime() / 1e9:.3f} GCell/s "
        f"(host clock, frames excluded) [{card}]")
    assert {k for k, c in counts.items() if c} == {"tile_pass"}, counts
    assert n_frames == n_run // n_snap, n_frames
    grid, run, _, options = path
    one_shot, _ = run(grid, n_run, **options)
    e = max_err(out.arrays, one_shot.arrays)
    log(f"  fdtd.run with snapshots against one call of {n_run}: max_abs_err={e:.3g} (tol {FDTD_ATOL})")
    assert e <= FDTD_ATOL, e
    return counts, e


def multi_device_runs(paths, counters, card) -> tuple[dict, dict, float]:
    """Phase 4, the multi-device paths (:data:`MULTI_PATHS`), each with the
    launch counters set to 0 just before it and read just after: only the
    tile pass launches; finite fields; the same grid through ``tiling`` at
    the same n (the single-card path, run beside it for its walltime) equal
    bit for bit; then at a reduced n (12; FDTD across its detect iteration)
    equal to ``reference`` and to the plain local compute
    (``local_compute="plain"``). Returns the updates, the launch counts and
    the largest difference."""
    import torch

    from stencilstream_tpu_torch.core.cell import cell_leaves

    runs, counts, worst = {}, {}, 0.0
    for name, tol in MULTI_PATHS.items():
        grid, run, n, options = paths[name]
        for module in counters.values():
            module.launches = 0
        out, update = run(grid, n, **options)
        counts[name] = {k: m.launches for k, m in counters.items()}
        runs[name] = update
        cells = grid.shape[0] * grid.shape[1] * n
        one_card = {k: v for k, v in options.items() if k not in ("mesh", "iters_per_pass")}
        single, single_update = run(grid, n, **{**one_card, "backend": "tiling"})
        log(f"  {name}, n={n}: {update.resolved_config}; launches {counts[name]}; walltime "
            f"{update.get_walltime():.6f} s, {cells / update.get_walltime() / 1e9:.3f} GCell/s; tiling on the same "
            f"card {single_update.resolved_config} {single_update.get_walltime():.6f} s, "
            f"{cells / single_update.get_walltime() / 1e9:.3f} GCell/s (host clock; the mesh's positions share "
            f"one card) [{card}]")
        assert {k for k, c in counts[name].items() if c} == {"tile_pass"}, (name, counts[name])
        for field, before in zip(cell_leaves(out.arrays), cell_leaves(grid.arrays)):
            assert tuple(field.shape) == grid.shape and field.dtype == before.dtype, name
            assert bool(torch.isfinite(field.float()).all()), name
        e = max_err(out.arrays, single.arrays)
        log(f"  {name}, n={n}: against tiling max_abs_err={e:.3g} (tol 0)")
        assert e == 0, (name, e)
        del out, single
        tf = update.params.transition_function
        at = {"iteration_offset": tf.detect_iteration - 6} if name.startswith("fdtd") else {}
        got, _ = run(grid, 12, **options, **at)
        want, _ = run(grid, 12, **{**one_card, "backend": "reference"}, **at)
        plain, _ = run(grid, 12, **options, **at, local_compute="plain")
        e_ref, e_plain = max_err(got.arrays, want.arrays), max_err(got.arrays, plain.arrays)
        worst = max(worst, e_ref, e_plain)
        log(f"  {name}, n=12 {at}: against reference max_abs_err={e_ref:.3g}, against local_compute='plain' "
            f"{e_plain:.3g} (tol {tol})")
        assert e_ref <= tol and e_plain <= tol, (name, e_ref, e_plain)
        del got, want, plain
    return runs, counts, worst


def convection_paths(paths, counters, card) -> tuple[dict, dict, dict]:
    """Phase 4, the four convection paths through ``convection.run`` as a
    user calls it, each with the launch counters set to 0 just before it:
    only the expected kernel launches; the fields are finite and the flow
    has started. Then each path at one block and one thermal step against
    the reference backend on the card: the same grid and statistics,
    exactly. Returns the runs, their launch counts and their final grids."""
    import torch

    from stencilstream_tpu_torch.core.cell import cell_leaves

    from stencilstream_tpu_torch.trace_cells import convection_experiment, convection_updates

    nerr = convection_experiment(1).nerr
    runs, counts, outs = {}, {}, {}
    for name, expect in CONVECTION_PATHS.items():
        grid, run, n, options = paths[name]
        for module in counters.values():
            module.launches = 0
        out, info = run(grid, n, **options)
        counts[name] = {k: m.launches for k, m in counters.items()}
        runs[name], outs[name] = info, out
        H, W = grid.shape
        pt, wall = info["pt_update"], info["pt_walltime"]
        cell_iterations = H * W * sum(s["iters"] for s in info["stats"])
        log(f"  {name}: {[(s['iters'], round(s['errV'], 6), round(s['errP'], 6)) for s in info['stats']]} "
            f"-> {getattr(pt, 'resolved_backend', 'tiling')} "
            f"{[getattr(u, 'resolved_config', None) for u in convection_updates(info)]} (lean, full, thermal); "
            f"launches {counts[name]}; pseudo-transient walltime {wall:.6f} s, "
            f"{cell_iterations / wall / 1e9:.3f} GCell/s, whole run {info['total_time']:.6f} s (host clock, "
            f"build excluded) [{card}]")
        assert {k for k, c in counts[name].items() if c} == {expect}, (name, counts[name])
        for field in cell_leaves(out.arrays):
            assert tuple(field.shape) == (H, W) and bool(torch.isfinite(field).all()), name
        assert float(out.arrays.Vy.abs().max()) > 0, name
        got, info1 = run(grid, nerr, nt=1, **options)
        want, ref1 = run(grid, nerr, nt=1, **{**options, "backend": "reference"})
        e = max_err(got.arrays, want.arrays)
        same = info1["stats"] == ref1["stats"]
        log(f"  {name}, one block and one thermal step: against reference max_abs_err={e:.3g} "
            f"(tol {CONVECTION_ATOL}), statistics equal: {same}")
        assert e <= CONVECTION_ATOL and same, (name, e, info1["stats"], ref1["stats"])
        del got, want
    return runs, counts, outs


def convection_kernel_rows(runs, counts, outs, device, card) -> dict:
    """Phase 5, the convection kernels on each path's final grid at the
    path's geometry: one pass of each of its updates (lean, full, thermal;
    the resident grid: one call of the update's n), device time by
    ``torch.profiler``, beside the plain version. Bound: each variant field
    read and written once, and each invariant field the functor reads read
    once (``cuda_lib.cell_traffic_bytes``; float32: full 44 + 40 B a cell,
    lean 36 + 32, thermal 12 + 4; float64 twice that), or ``n_operations``
    a cell-iteration (the pseudo-transient kernel: the reference harness's
    50) over 67 TFLOP/s in float32 and 34 in float64. No single PyTorch call
    computes a pass. Returns one row a (path, update)."""
    from stencilstream_tpu_torch.backends.cuda_lib import cell_traffic_bytes
    from stencilstream_tpu_torch.models import convection
    from stencilstream_tpu_torch.tile_sweep import device_ms
    from stencilstream_tpu_torch.trace_cells import convection_updates, kernel_launch

    rows = {}
    halo = convection.zero_cell()
    for name, kernel in CONVECTION_PATHS.items():
        cell = outs[name].arrays
        H, W = cell.T.shape
        for update in convection_updates(runs[name]):
            tf = update.params.transition_function
            launched, fn, plain, what, n = kernel_launch(update, cell, halo)
            assert launched == kernel, (name, launched)
            ms, call_ms, plain_ms = device_ms(fn, 5), cuda_ms(fn, 5), cuda_ms(plain, 1)
            assert ms > 0, f"the profiler saw no {kernel} kernel"
            e = max_err(fn(), plain())
            read, written = cell_traffic_bytes(cell, tf)
            wide = tf.dtype.itemsize == 8
            b, by = bound((read + written) * H * W, tf.n_operations * n * H * W, wide)
            row = f"{name} {tf.cuda_op}"
            log(f"  {kernel} {row} {H}x{W}, {what}: kernel {ms:.4f} ms (device time; {call_ms:.4f} ms a call back "
                f"to back) = {b / ms:.1%} of its bound {b:.4f} ms ({by}), plain {plain_ms:.4f} ms, library none: no "
                f"single PyTorch call, max_abs_err={e:.3g}, {counts[name][kernel]} launches on the path [{card}]")
            assert e <= CONVECTION_ATOL, (row, e)
            rows[row] = dict(kernel=kernel, ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                             max_abs_err=e, launches=counts[name][kernel], workload=f"{tf.cuda_op} {H}x{W}, {what}")
    return rows


def extended_kernel_row(runs, device, card) -> dict:
    """Phase 5, the tile pass in extended mode at the multi-device paths'
    shapes: HotSpot 8192^2 cut into the shards of a (2, 2) mesh (4096^2
    cores) and of a (4, 1) mesh (2048x8192), each at p=4 and p=8, at the
    paths' tiles. For each: the halo exchange of one pass (all shards, the
    temperature, as the backend exchanges it; CUDA events), one extended
    pass of the corner shard (0, 0)
    beside its plain version, and the pass's bound: the block's two fields
    (core and stored halo) read, the core's temperature written, over 3.35
    TB/s, or ``n_operations`` a cell-step of the core over 67 TFLOP/s. No
    single PyTorch call computes a pass. Returns the (2, 2), p=4 row (the
    ``kernels`` line's workload)."""
    from stencilstream_tpu_torch.backends import tile_pass as tp
    from stencilstream_tpu_torch.core.cell import cell_map
    from stencilstream_tpu_torch.models import hotspot
    from stencilstream_tpu_torch.parallel import exchange_halo, make_mesh

    cell = hotspot_cell((8192, 8192), 7, device)
    tf = hotspot.derive_coefficients(8192, 8192)
    hz = hotspot.HotspotCell(temp=0.0, power=0.0)
    rows = {}
    for name in ("hotspot 8192^2 distributed 2x2", "hotspot 8192^2 distributed 2x2 p=8",
                 "hotspot 8192^2 distributed 4x1", "hotspot 8192^2 distributed 4x1 p=8"):
        cfg = runs[name].resolved_config
        (ny, nx), (h, w), stored, p = cfg["mesh"], cfg["shard"], cfg["stored_halo"], cfg["iters_per_pass"]
        tile = (cfg["tile_rows"], cfg["tile_cols"])
        mesh = make_mesh(shape=(ny, nx), devices=[device] * (ny * nx))
        blocks = [[cell_map(lambda a: a[iy * h:(iy + 1) * h, ix * w:(ix + 1) * w].contiguous(), cell)
                   for ix in range(nx)] for iy in range(ny)]
        # A pass exchanges the temperature only: the power map, which HotSpot
        # only reads, is exchanged once a call.
        temps = [[b.temp for b in row] for row in blocks]
        exchange_ms = cuda_ms(lambda: exchange_halo(temps, stored, mesh), 10)
        ext = exchange_halo(blocks, stored, mesh)[0][0]
        kw = dict(i_start=0, offset=0, n_iterations=p, iters_per_pass=p, origin=(-stored[0], -stored[1]),
                  grid_range=(8192, 8192), stored_halo=stored)
        ms = cuda_ms(lambda: tp.tile_pass(ext, tf, hz, tile=tile, **kw), 10)
        plain_ms = cuda_ms(lambda: tp.tile_pass_plain(ext, tf, hz, **kw), 2)
        e = max_err(tp.tile_pass(ext, tf, hz, tile=tile, **kw), tp.tile_pass_plain(ext, tf, hz, **kw))
        Hs, Ws = ext.temp.shape
        b, by = bound(8 * Hs * Ws + 4 * h * w, tf.n_operations * p * h * w)
        share = exchange_ms / (exchange_ms + ny * nx * ms)
        log(f"  tile_pass_extended {name}: shard {h}x{w}, stored halo {stored}, tile {tile}, p={p}: kernel "
            f"{ms:.4f} ms = {b / ms:.1%} of its bound {b:.4f} ms ({by}), plain {plain_ms:.4f} ms, library none, "
            f"max_abs_err={e:.3g}; exchange of a pass {exchange_ms:.4f} ms, {share:.1%} of a pass's "
            f"exchange and {ny * nx} kernels [{card}]")
        assert e <= ATOL, (name, e)
        rows[name] = dict(
            name="tile_pass_extended", route="cuda", source="stencilstream_tpu_torch/csrc/tile_pass.cu",
            replaces="stencilstream_tpu/backends/strip_pass.py:535", ms=ms, plain_ms=plain_ms, bound_ms=b,
            bound_by=by, library_ms=None, max_abs_err=e, exchange_ms=exchange_ms,
            workload=f"hotspot 8192x8192 shard (0, 0) of a ({ny}, {nx}) mesh, {h}x{w} core, stored halo "
                     f"{stored}, one pass of p={p}, tile {tile}",
        )
        del blocks, ext
    return rows["hotspot 8192^2 distributed 2x2"]


def narrow_kernel_rows(runs, path_counts, device, card, limits, n_mono: int) -> dict:
    """Phase 5, the three kernels on bfloat16 cells at the narrow paths'
    geometry: one Jacobi5 8192^2 pass through the tile pass (at the bf16
    ``auto`` path's tile and p) and the line cache (at its law's geometry
    for that p) in turns, against p ``conv2d`` calls on bfloat16 tensors;
    Jacobi5 1024^2, n=``n_mono``, on the resident grid, against as many
    ``conv2d`` calls. Bound: 2 B read and 2 B written a cell
    (``cuda_lib.cell_traffic_bytes``), or n_operations a cell-iteration.
    Beside them, logged: HotSpot 8192^2 bf16 and Jacobi5 8192^2 float8 one
    pass of the tile pass, FDTD coef 1024^2 bf16 one pass (device time by
    ``torch.profiler``), each against its plain version. Returns one row a
    kernel."""
    import torch

    from stencilstream_tpu_torch.backends import cuda_lib
    from stencilstream_tpu_torch.backends import line_cache as lc
    from stencilstream_tpu_torch.backends import monotile as mt
    from stencilstream_tpu_torch.backends import tile_pass as tp
    from stencilstream_tpu_torch.backends.storage_cast import CastStorageKernel, cast_storage
    from stencilstream_tpu_torch.models import hotspot, jacobi
    from stencilstream_tpu_torch.tdv import tdv_stream
    from stencilstream_tpu_torch.tile_sweep import device_ms
    from stencilstream_tpu_torch.trace_cells import JACOBI5_COEFS

    launches = dict.fromkeys(("tile_pass", "line_cache", "monotile"), 0)
    for name in NARROW_PATHS:
        for k in launches:
            launches[k] += path_counts[name][k]
    j5 = CastStorageKernel(jacobi.make_kernel("jacobi5_general", JACOBI5_COEFS))
    x = cast_storage(torch.tensor(np.random.default_rng(11).random((8192, 8192), np.float32), device=device))
    cells = 8192 * 8192
    cfg = runs["jacobi5 bf16 8192^2 auto"].resolved_config
    p, tile = cfg["iters_per_pass"], (cfg["tile_rows"], cfg["tile_cols"])
    kw = dict(i_start=0, offset=0, n_iterations=p, iters_per_pass=p)
    t = in_turns(x, j5, 0.0, tile, p, limits, 20)
    plain = tp.tile_pass_plain(x, j5, 0.0, **kw)
    plain_ms = cuda_ms(lambda: tp.tile_pass_plain(x, j5, 0.0, **kw), 2)
    errs = {k: max_err(out, plain) for k, out in t["out"].items()}
    torch.backends.cudnn.benchmark = True
    lib_ms = cuda_ms(lambda: library_jacobi(x, p), 10)
    lib_err = max_err(library_jacobi(x, p), plain)
    read, written = cuda_lib.cell_traffic_bytes(x, j5)
    b, by = bound((read + written) * cells, j5.n_operations * p * cells)
    lc_geometry = {k: runs["jacobi5 bf16 8192^2 tiling linecache"].resolved_config[k] for k in t["geometry"]}
    log(f"  jacobi5 bf16 8192x8192 p={p}: tile_pass {t['times']['tile_pass']} ms at {tile}, line_cache "
        f"{t['times']['line_cache']} ms at {t['geometry']} (in turns; the path ran {lc_geometry}), plain "
        f"{plain_ms:.4f} ms, {p} x bf16 conv2d {lib_ms:.4f} ms tuned, against plain max_abs_err={lib_err:.3g} (tol "
        f"{LIBRARY_BF16_ATOL}: cuDNN rounds once a call); kernels against plain {errs}; bound {b:.4f} ms ({by}, "
        f"{read} + {written} B a cell): tile_pass {b / t['ms']['tile_pass']:.1%}, line_cache "
        f"{b / t['ms']['line_cache']:.1%}; {tp.tile_pass_residency(j5, tile, p, device)} tile-pass and "
        f"{lc.line_cache_residency(j5, t['geometry']['strip_rows'], t['geometry']['panel_cols'], p, device)} "
        f"line-cache CTAs resident per SM [{card}]")
    assert max(errs.values()) <= NARROW_ATOL and lib_err <= LIBRARY_BF16_ATOL, (errs, lib_err)
    rows = {}
    for k in ("tile_pass", "line_cache"):
        where = f"tile {tile}" if k == "tile_pass" else str(t["geometry"])
        rows[k] = dict(ms=t["ms"][k], plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=lib_ms,
                       max_abs_err=errs[k], launches=launches[k],
                       workload=f"jacobi5_general bf16 8192x8192, one pass of p={p}, {where}")
    del x, plain, t

    y = cast_storage(torch.tensor(np.random.default_rng(12).random((1024, 1024), np.float32), device=device))
    cells = 1024 * 1024
    ms = cuda_ms(lambda: mt.monotile(y, j5, 0.0, offset=0, n_iterations=n_mono), 5)
    plain_ms = cuda_ms(lambda: mt.monotile_plain(y, j5, 0.0, offset=0, n_iterations=n_mono), 1)
    e = max_err(mt.monotile(y, j5, 0.0, offset=0, n_iterations=n_mono),
                mt.monotile_plain(y, j5, 0.0, offset=0, n_iterations=n_mono))
    lib_ms = cuda_ms(lambda: library_jacobi(y, n_mono), 2)
    b, by = bound((read + written) * cells, j5.n_operations * n_mono * cells)
    plan = mt.monotile_plan(1024, 1024, 1, cuda_lib.cell_smem_bytes(y, j5), limits)
    log(f"  monotile jacobi5 bf16 1024x1024 n={n_mono} (band {plan.band}, q={plan.q}, {plan.threads} threads): "
        f"kernel {ms:.4f} ms = {b / ms:.1%} of its bound {b:.4f} ms ({by}), plain {plain_ms:.4f} ms, {n_mono} x bf16 "
        f"conv2d {lib_ms:.4f} ms tuned, max_abs_err={e:.3g} [{card}]")
    assert e <= NARROW_ATOL, e
    rows["monotile"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=lib_ms, max_abs_err=e,
                            launches=launches["monotile"],
                            workload=f"jacobi5_general bf16 1024x1024, n={n_mono} in one launch")
    del y

    # Beside them: HotSpot bf16 and Jacobi5 float8 on the tile pass, FDTD
    # coef bf16's pass (shorter than its host call: device time).
    hs_cfg = runs["hotspot bf16 8192^2 auto"].resolved_config
    e8_cfg = runs["jacobi5 e4m3 8192^2 tiling"].resolved_config
    rng = np.random.default_rng(13)
    hot = cast_storage(hotspot_cell((8192, 8192), 13, device))
    cases = {
        "hotspot bf16": (hot, CastStorageKernel(hotspot.derive_coefficients(8192, 8192)),
                         hotspot.HotspotCell(temp=0.0, power=0.0), hs_cfg),
        "jacobi5_general float8_e4m3fn": (
            cast_storage(torch.tensor(rng.random((8192, 8192), np.float32), device=device), torch.float8_e4m3fn),
            CastStorageKernel(j5.tf, torch.float8_e4m3fn), 0.0, e8_cfg),
    }
    for what, (cell, tf, halo, cfg) in cases.items():
        p, tile = cfg["iters_per_pass"], (cfg["tile_rows"], cfg["tile_cols"])
        kw = dict(i_start=0, offset=0, n_iterations=p, iters_per_pass=p)
        ms = cuda_ms(lambda: tp.tile_pass(cell, tf, halo, tile=tile, **kw), 10)
        plain_ms = cuda_ms(lambda: tp.tile_pass_plain(cell, tf, halo, **kw), 2)
        e = max_err(tp.tile_pass(cell, tf, halo, tile=tile, **kw), tp.tile_pass_plain(cell, tf, halo, **kw))
        read, written = cuda_lib.cell_traffic_bytes(cell, tf)
        b, by = bound((read + written) * 8192 * 8192, tf.n_operations * p * 8192 * 8192)
        log(f"  tile_pass {what} 8192x8192 tile={tile} p={p}: kernel {ms:.4f} ms = {b / ms:.1%} of its bound "
            f"{b:.4f} ms ({by}, {read} + {written} B a cell), plain {plain_ms:.4f} ms, max_abs_err={e:.3g}; "
            f"{tp.tile_pass_residency(tf, tile, p, device)} CTAs resident per SM [{card}]")
        assert e <= NARROW_ATOL, (what, e)
        rows["tile_pass"]["max_abs_err"] = max(rows["tile_pass"]["max_abs_err"], e)
    del hot, cases
    name = "fdtd coef bf16 1024^2 auto"
    update = runs[name]
    tf, cfg = update.params.transition_function, update.resolved_config
    p, tile = cfg["iters_per_pass"], (cfg["tile_rows"], cfg["tile_cols"])
    cell = cast_storage(fdtd_case("coef", (1024, 1024), np.random.default_rng(14), device, 0)[0])
    halo = tf.resolver.halo_cell()
    kw = dict(i_start=0, offset=0, n_iterations=p, iters_per_pass=p, tdv=tdv_stream(tf, 0, p, device))
    fn = lambda: tp.tile_pass(cell, tf, halo, tile=tile, **kw)  # noqa: E731
    ms, call_ms = device_ms(fn, 50), cuda_ms(fn, 50)
    plain_ms = cuda_ms(lambda: tp.tile_pass_plain(cell, tf, halo, **kw), 1)
    e = max_err(fn(), tp.tile_pass_plain(cell, tf, halo, **kw))
    read, written = cuda_lib.cell_traffic_bytes(cell, tf)
    b, by = bound((read + written) * 1024 * 1024, tf.n_operations * p * 1024 * 1024)
    log(f"  tile_pass fdtd coef bf16 1024x1024 tile={tile} p={p}: kernel {ms:.4f} ms (device time; {call_ms:.4f} ms a "
        f"call back to back) = {b / ms:.1%} of its bound {b:.4f} ms ({by}, {read} + {written} B a cell), plain "
        f"{plain_ms:.4f} ms, max_abs_err={e:.3g}, {path_counts[name]['tile_pass']} launches on the path [{card}]")
    assert ms > 0 and e <= NARROW_ATOL, (ms, e)
    rows["tile_pass"]["max_abs_err"] = max(rows["tile_pass"]["max_abs_err"], e)
    return rows


def fdtd_kernel_rows(runs, path_counts, fdtd_outs, device, card, n_mono: int) -> dict:
    """Phase 5, FDTD's kernels on the main paths' state after their runs and
    at their geometry (no single PyTorch call computes FDTD): one pass of
    the coef and of the lut 1024^2 path on the tile pass, one pass of the
    render 1024^2 path on the line cache, coef 512^2 at n=``n_mono`` on the
    resident grid, each beside its plain version. Bound: 32 B read and 16 B
    written a coef cell (lut 20 and 16, render 16 and 16), or n_operations
    a cell-iteration. Returns one row a kernel and workload."""
    from stencilstream_tpu_torch.backends import cuda_lib
    from stencilstream_tpu_torch.backends import line_cache as lc
    from stencilstream_tpu_torch.backends import monotile as mt
    from stencilstream_tpu_torch.backends import tile_pass as tp
    from stencilstream_tpu_torch.core.cell import cell_leaves
    from stencilstream_tpu_torch.tdv import tdv_stream
    from stencilstream_tpu_torch.tile_sweep import device_ms

    def fdtd_row(kernel, name, fn, plain, n_bytes, cell_steps, reps, what):
        # Device time (torch.profiler): a pass is shorter than its host call.
        ms, call_ms, plain_ms = device_ms(fn, reps), cuda_ms(fn, reps), cuda_ms(plain, 1)
        assert ms > 0, f"the profiler saw no {kernel} kernel"
        e = max_err(fn(), plain())
        b, by = bound(n_bytes, runs[name].params.transition_function.n_operations * cell_steps)
        log(f"  {kernel} {what}: kernel {ms:.4f} ms (device time; {call_ms:.4f} ms a call back to back) = "
            f"{b / ms:.1%} of its bound {b:.4f} ms ({by}), plain {plain_ms:.4f} ms, library none: no single "
            f"PyTorch call, max_abs_err={e:.3g}, {path_counts[name][kernel]} launches on the path [{card}]")
        assert e <= FDTD_ATOL, (kernel, e)
        return dict(kernel=kernel, ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                    max_abs_err=e, launches=path_counts[name][kernel], workload=what)

    fdtd_kernels = {}
    for key, kernel, name in (("tile_pass", "tile_pass", "fdtd coef 1024^2 auto"),
                              ("tile_pass lut", "tile_pass", "fdtd lut 1024^2 auto"),
                              ("line_cache", "line_cache", "fdtd render 1024^2 tiling linecache")):
        cfg, tf = runs[name].resolved_config, runs[name].params.transition_function
        cell = fdtd_outs[name].arrays
        halo = tf.resolver.halo_cell()
        p = cfg["iters_per_pass"]
        h, w = cell.hz.shape
        kw = dict(i_start=0, offset=0, n_iterations=p, iters_per_pass=p, tdv=tdv_stream(tf, 0, p, device))
        if kernel == "tile_pass":
            tile = (cfg["tile_rows"], cfg["tile_cols"])
            fn = lambda: tp.tile_pass(cell, tf, halo, tile=tile, **kw)  # noqa: E731
            what = f"fdtd {tf.resolver.name} {h}x{w}, one pass of p={p}, tile {tile}"
        else:
            geometry = {k: cfg[k] for k in ("strip_rows", "panel_cols", "segment_rows")}
            fn = lambda: lc.line_cache_pass(cell, tf, halo, **geometry, **kw)  # noqa: E731
            what = f"fdtd {tf.resolver.name} {h}x{w}, one pass of p={p}, {geometry}"
        cells = h * w
        n_bytes = (sum(t.element_size() for t in cell_leaves(cell)) + 16) * cells
        fdtd_kernels[key] = fdtd_row(kernel, name, fn, lambda: tp.tile_pass_plain(cell, tf, halo, **kw),
                                     n_bytes, p * cells, 50, what)
    name = "fdtd coef 512^2 auto"
    tf = runs[name].params.transition_function
    cell, halo = fdtd_outs[name].arrays, tf.resolver.halo_cell()
    h, w = cell.hz.shape
    cells = h * w
    stream = tdv_stream(tf, 0, n_mono, device)
    plan = mt.monotile_plan(h, w, 1, 48, cuda_lib.device_limits(device))
    fdtd_kernels["monotile"] = fdtd_row(
        "monotile", name, lambda: mt.monotile(cell, tf, halo, offset=0, n_iterations=n_mono, tdv=stream),
        lambda: mt.monotile_plain(cell, tf, halo, offset=0, n_iterations=n_mono, tdv=stream),
        48 * cells, n_mono * cells, 5,
        f"fdtd coef {h}x{w}, n={n_mono} in one launch (band {plan.band}, q={plan.q}, {plan.threads} threads)",
    )
    return fdtd_kernels


def experiments_phase(device, card, launches) -> list:
    """Phase 6, the ``experiments/`` microbenchmarks' two kernels: every
    variant of the strip kernel (``csrc/micro_strip.cu``) at each p it is
    built for, on 1024x1000 in strips of 128, and of the line-cache kernel
    (``csrc/micro_linecache.cu``) on 1024x1000 plus pad rows in strips of
    128, each exactly against its plain version (NaN
    equal to NaN; the rows a ``*_noinit`` variant leaves undefined not
    compared); then each entry point's default configuration once at 8192^2
    (lc_bisect at its 1024^2) with few passes, and ``micro_linecache
    --check``; last one row of the ``kernels`` line per TPU kernel, each at
    its script's default workload: the kernel's time, its plain version's,
    the bound and, where p ``conv2d`` calls compute the same function, their
    time. ``launches`` are the main paths' (none of them runs these
    kernels)."""
    import torch

    from stencilstream_tpu_torch.experiments import (
        lc_bisect, linecache, micro_linecache, micro_operands, micro_order, micro_shifts, strip)

    t0 = time.perf_counter()
    rng = np.random.default_rng(11)
    errs = {"strip": 0.0, "linecache": 0.0}
    x = torch.tensor(rng.random((1024, 1000), np.float32), device=device)
    scalars = strip.StripScalars(coefs=(0.11, 0.21, 0.31, 0.41, 0.17), hv=0.5)
    for name, v in strip.VARIANTS.items():
        for p in v.ps:
            e = max_err(strip.strip_pass(x, name, T=128, hp=p, p=p, scalars=scalars),
                        strip.strip_pass_plain(x, name, T=128, hp=p, p=p, scalars=scalars))
            errs["strip"] = max(errs["strip"], e)
            assert e == 0, (name, p, e)
    for name, v in linecache.VARIANTS.items():
        for p in v.ps:
            xa = torch.tensor(linecache.zero_pad(rng.random((1024, 1000), np.float32), 128 if v.blocked else 32),
                              device=device)
            skip = linecache.undefined_rows(name, p)
            e = max_err(linecache.linecache_pass(xa, name, H=1024, T=128, p=p)[skip:],
                        linecache.linecache_pass_plain(xa, name, H=1024, T=128, p=p)[skip:])
            errs["linecache"] = max(errs["linecache"], e)
            assert e == 0, (name, p, e)
    log(f"  every variant against its plain version: strip kernel max_abs_err={errs['strip']:.3g} "
        f"({sum(len(v.ps) for v in strip.VARIANTS.values())} variant-p pairs), line-cache kernel "
        f"max_abs_err={errs['linecache']:.3g} ({sum(len(v.ps) for v in linecache.VARIANTS.values())} "
        f"pairs) at {time.perf_counter() - t0:.1f} s")
    del x

    # The entry points, as a user runs them (their own output lines).
    entry_points = [
        ("micro_shifts", micro_shifts.main, ["--iters", "64"]),
        ("micro_operands", micro_operands.main, ["--n1", "2", "--n2", "8"]),
        ("micro_order", micro_order.main, ["--n1", "2", "--n2", "8"]),
        ("micro_linecache", micro_linecache.main, ["--iters", "64"]),
        ("micro_linecache --check", micro_linecache.main, ["--check"]),
        *[(f"lc_bisect {v}", lc_bisect.main, [v, "--passes", "20"]) for v in lc_bisect.VARIANTS],
    ]
    for label, main_fn, argv in entry_points:
        log(f"  python -m stencilstream_tpu_torch.experiments.{label.split()[0]} {' '.join(argv)}:")
        assert main_fn(argv) == 0, label
    log(f"  entry points done at {time.perf_counter() - t0:.1f} s")

    def library_micro(y, steps, weights):
        """``steps`` Jacobi5 steps with halo 0 as ``conv2d`` calls:
        ``weights`` of (centre, north, south, west, east)."""
        c, n, s_, w, e = weights
        k = torch.tensor([[0, n, 0], [w, c, e], [0, s_, 0]], dtype=y.dtype, device=y.device).view(1, 1, 3, 3)
        y = y.view(1, 1, *y.shape)
        for _ in range(steps):
            y = torch.nn.functional.conv2d(y, k, padding=1)
        return y.view(y.shape[2:])

    rows = []
    shifts_w = strip.COEFS  # (W0, WN, WS, WW, WE): centre, north, south, west, east
    c0, c1, c2, c3, c4 = strip.COEFS  # micro_operands' and micro_order's: north, west, south, east, centre
    operands_w = (c4, c0, c2, c1, c3)
    side = 8192
    x = torch.tensor(rng.random((side, side), np.float32), device=device)
    for script, variant, weights, line in (("micro_shifts", "inline", shifts_w, 187),
                                           ("micro_operands", "baseline", operands_w, 115),
                                           ("micro_order", "centerfirst", operands_w, 75)):
        kw = dict(T=128, hp=8, p=8)
        ms = cuda_ms(lambda: strip.strip_pass(x, variant, **kw), 10)
        plain_ms = cuda_ms(lambda: strip.strip_pass_plain(x, variant, **kw), 1)
        lib_ms = cuda_ms(lambda: library_micro(x, 8, weights), 10)
        got = strip.strip_pass(x, variant, **kw)
        e = max_err(got, strip.strip_pass_plain(x, variant, **kw))
        lib_e = max_err(library_micro(x, 8, weights), got)
        b, by = bound(strip.pass_bytes(side, side), strip.pass_operations(variant, side, side, kw["p"]))
        log(f"  {script} {variant} {side}x{side} T=128 p=8: kernel {ms:.4f} ms = {b / ms:.1%} of its bound "
            f"{b:.4f} ms ({by}), plain {plain_ms:.4f} ms, 8 x conv2d {lib_ms:.4f} ms (against the kernel "
            f"max_abs_err={lib_e:.3g}, tol {LIBRARY_ATOL}), max_abs_err={e:.3g} [{card}]")
        assert e == 0 and lib_e <= LIBRARY_ATOL
        rows.append(dict(
            name=f"micro_strip/{script}", route="cuda", source="stencilstream_tpu_torch/csrc/micro_strip.cu",
            replaces=f"experiments/{script}.py:{line}", launches=launches["micro_strip"],
            max_abs_err=max(e, errs["strip"]), ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
            library_ms=lib_ms, workload=f"{variant} {side}x{side}, strips of 128, hp=p=8, one pass"))
    del x, got
    for script, variant, H, T, p, pad, line in (("micro_linecache", "lc", side, 256, 16, 16, 120),
                                                ("lc_bisect", "scratch3d", 1024, 128, 8, 8, 80)):
        xa = torch.tensor(linecache.zero_pad(rng.random((H, H), np.float32), pad), device=device)
        kw = dict(H=H, T=T, p=p)
        ms = cuda_ms(lambda: linecache.linecache_pass(xa, variant, **kw), 10)
        plain_ms = cuda_ms(lambda: linecache.linecache_pass_plain(xa, variant, **kw), 1)
        e = max_err(linecache.linecache_pass(xa, variant, **kw), linecache.linecache_pass_plain(xa, variant, **kw))
        b, by = bound(linecache.pass_bytes(H, H + pad, H), linecache.pass_operations(H, H, p))
        log(f"  {script} {variant} {H}x{H} + {pad} pad rows T={T} p={p}: kernel {ms:.4f} ms = {b / ms:.1%} of "
            f"its bound {b:.4f} ms ({by}), plain {plain_ms:.4f} ms, library none: no PyTorch call computes "
            f"the zero-carry skew, max_abs_err={e:.3g} [{card}]")
        assert e == 0
        rows.append(dict(
            name=f"micro_linecache/{script}", route="cuda", source="stencilstream_tpu_torch/csrc/micro_linecache.cu",
            replaces=f"experiments/{script}.py:{line}", launches=launches["micro_linecache"],
            max_abs_err=max(e, errs["linecache"]), ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
            library_ms=None, workload=f"{variant} {H}x{H} + {pad} pad rows, strips of {T}, p={p}, one pass"))
        del xa
    log(f"phase 6 took {time.perf_counter() - t0:.1f} s")
    return rows


def main() -> int:
    import torch

    # Phase 1: the card.
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")
    t_start = time.perf_counter()

    from stencilstream_tpu_torch import Grid
    from stencilstream_tpu_torch.backends import cuda_lib
    from stencilstream_tpu_torch.backends import line_cache as lc
    from stencilstream_tpu_torch.backends import monotile as mt
    from stencilstream_tpu_torch.backends import tile_pass as tp
    from stencilstream_tpu_torch.backends.tiling import TILE_LAW
    from stencilstream_tpu_torch.core.cell import cell_leaves
    from stencilstream_tpu_torch.models import conway, fdtd, hotspot, jacobi
    from stencilstream_tpu_torch.tdv import tdv_stream
    from stencilstream_tpu_torch.trace_cells import JACOBI5_COEFS, main_paths

    limits = cuda_lib.device_limits(device)
    log(f"device limits: {limits}")

    # Phase 2: build.
    path, seconds, report = cuda_lib.build()
    cuda_lib.library()
    log(f"built {path.name} in {seconds:.1f} s")
    for line in report.splitlines():
        if "Used" in line or "spill" in line:
            log("  ptxas:", line.strip())
    from stencilstream_tpu_torch.tile_sweep import kernel_report

    for kernel in ("tile_pass_kernel", "monotile_kernel", "line_cache_kernel"):
        for functor, lines in kernel_report(report, kernel).items():
            if "Convection" in functor:
                log(f"  ptxas {kernel} {functor}: {' | '.join(lines)}")

    # Phase 3: kernels against their plain versions.
    log("kernel checks:")
    errs = check_kernels(device)
    log(f"phase 3 done at {time.perf_counter() - t_start:.1f} s")

    # Phase 4: the main paths, through the entry points a user calls.
    from stencilstream_tpu_torch.experiments import linecache as micro_lc
    from stencilstream_tpu_torch.experiments import strip as micro_strip

    counters = {"tile_pass": tp, "monotile": mt, "line_cache": lc, "micro_strip": micro_strip,
                "micro_linecache": micro_lc}
    # name: (reduced n for the reference check, tolerance, kernels it must launch)
    checks = {
        "hotspot 1024^2 auto": (20, ATOL, {"monotile"}),
        "hotspot 8192^2 auto": (12, ATOL, {"tile_pass"}),
        "jacobi5 8192^2 tiling linecache": (12, JACOBI_ATOL, {"line_cache"}),
        "jacobi5 8192^2 auto": (12, JACOBI_ATOL, {"tile_pass"}),
        "jacobi5 1024^2 auto": (20, JACOBI_ATOL, {"monotile"}),
        "conway 8192^2 auto": (12, 0.0, {"tile_pass"}),
        "fdtd coef 1024^2 auto": (12, FDTD_ATOL, {"tile_pass"}),
        "fdtd coef 512^2 auto": (12, FDTD_ATOL, {"monotile"}),
        "fdtd render 1024^2 tiling linecache": (12, FDTD_ATOL, {"line_cache"}),
        "fdtd lut 1024^2 auto": (12, FDTD_ATOL, {"tile_pass"}),
        **{name: (12, NARROW_ATOL, {kernel}) for name, kernel in NARROW_PATHS.items()},
        "hotspot 2048^2 auto": (12, ATOL, {"tile_pass"}),
    }
    paths = main_paths(device)
    assert set(paths) == set(checks) | set(CONVECTION_PATHS) | set(MULTI_PATHS), sorted(paths)
    totals = dict.fromkeys(counters, 0)
    path_errs = dict.fromkeys(counters, 0.0)
    runs, path_counts, fdtd_outs = {}, {}, {}
    for name, (grid, run, n, options) in paths.items():
        if name in CONVECTION_PATHS or name in MULTI_PATHS:
            continue
        n_small, tol, expect = checks[name]
        for module in counters.values():
            module.launches = 0
        out, update = run(grid, n, **options)
        counts = {k: m.launches for k, m in counters.items()}
        runs[name], path_counts[name] = update, counts
        launched = {k for k, c in counts.items() if c}
        log(f"  {name}, n={n}: -> {getattr(update, 'resolved_backend', 'tiling')} "
            f"{update.resolved_config or ''}; launches {counts}; walltime {update.get_walltime():.6f} s, "
            f"{grid.shape[0] * grid.shape[1] * n / update.get_walltime() / 1e9:.3f} GCell/s "
            f"(host clock, build excluded) [{card}]")
        assert launched == expect, (name, counts)
        for k in counters:
            totals[k] += counts[k]
        fields = cell_leaves(out.arrays)
        for field, before in zip(fields, cell_leaves(grid.arrays)):
            assert tuple(field.shape) == grid.shape and field.dtype == before.dtype, name
            assert field.dtype == torch.bool or bool(torch.isfinite(field.float()).all()), name
        if name.startswith("conway"):
            assert fields[0].dtype == torch.bool and 0 < int(fields[0].sum()) < fields[0].numel(), name
        if name.startswith("fdtd"):
            # The pulse has crossed the ring, and hz_sum accumulated after detect.
            assert float(out.arrays.hz.abs().max()) > 0 and float(out.arrays.hz_sum.max()) > 0, name
            fdtd_outs[name] = out
        # The same path at a reduced n against the plain reference backend;
        # FDTD's also from an offset across the detect iteration.
        tf = update.params.transition_function
        offsets = [0, tf.detect_iteration - n_small // 2] if name.startswith("fdtd") else [0]
        for offset in offsets:
            at = {"iteration_offset": offset} if offset else {}
            got, _ = run(grid, n_small, **options, **at)
            want, _ = run(grid, n_small, backend="reference", **at)
            e = max_err(got.arrays, want.arrays)
            for k in expect:
                path_errs[k] = max(path_errs[k], e)
            log(f"  {name}, n={n_small} from {offset}: against reference max_abs_err={e:.3g} (tol {tol})")
            assert e <= tol, (name, e)
        del out, got, want
    counts, e = fdtd_user_run(paths["fdtd coef 1024^2 auto"], counters, card)
    for k in counters:
        totals[k] += counts[k]
    path_errs["tile_pass"] = max(path_errs["tile_pass"], e)
    conv_runs, conv_counts, conv_outs = convection_paths(paths, counters, card)
    for name, kernel in CONVECTION_PATHS.items():
        for k in counters:
            totals[k] += conv_counts[name][k]
    log(f"main path launches: {totals}")
    multi_runs, multi_counts, multi_err = multi_device_runs(paths, counters, card)
    extended_launches = sum(c["tile_pass"] for c in multi_counts.values())
    log(f"multi-device path launches: {extended_launches} of the tile pass in extended mode, "
        f"{ {name: c['tile_pass'] for name, c in multi_counts.items()} }")
    del paths
    torch.cuda.empty_cache()
    log(f"phase 4 done at {time.perf_counter() - t_start:.1f} s")

    # Phase 5: kernel, plain and library times at the main paths' shapes.
    # The `kernels` line keeps one workload per kernel from PR to PR: the
    # tile pass at HotSpot 8192^2, the resident grid at HotSpot 1024^2, the
    # line cache at Jacobi5 8192^2; the others are logged beside them.
    kernels = {}
    cells = 8192 * 8192
    hz = hotspot.HotspotCell(temp=0.0, power=0.0)
    cell = hotspot_cell((8192, 8192), 7, device)
    tf = hotspot.derive_coefficients(8192, 8192)
    hs_cfg = runs["hotspot 8192^2 auto"].resolved_config
    p, tile = hs_cfg["iters_per_pass"], (hs_cfg["tile_rows"], hs_cfg["tile_cols"])
    kw = dict(i_start=0, offset=0, n_iterations=p, iters_per_pass=p)
    ms = cuda_ms(lambda: tp.tile_pass(cell, tf, hz, tile=tile, **kw), 10)
    plain_ms = cuda_ms(lambda: tp.tile_pass_plain(cell, tf, hz, **kw), 2)
    e = max_err(tp.tile_pass(cell, tf, hz, tile=tile, **kw), tp.tile_pass_plain(cell, tf, hz, **kw))
    b, by = bound(12 * cells, tf.n_operations * p * cells)
    log(f"  tile_pass hotspot 8192x8192 tile={tile} p={p}: kernel {ms:.4f} ms = {b / ms:.1%} of its "
        f"bound {b:.4f} ms ({by}), plain {plain_ms:.4f} ms, max_abs_err={e:.3g} [{card}]")
    assert e <= ATOL
    per_sm = tp.tile_pass_residency(tf, tile, p, device)
    log(f"  tile_pass hotspot tile={tile} p={p}: {per_sm} CTAs resident per SM by the CUDA occupancy "
        f"calculator (the law sized the window for {TILE_LAW[12][2]})")
    # Beside it, the line cache on the same pass: the invariant-field path.
    want = tp.tile_pass_plain(cell, tf, hz, **kw)
    t = in_turns(cell, tf, hz, tile, p, limits, 10)
    lc_e = max(max_err(t["out"]["line_cache"], want), max_err(t["out"]["tile_pass"], want))
    log(f"  hotspot 8192x8192 p={p}: tile_pass {t['times']['tile_pass']} ms, line_cache "
        f"{t['times']['line_cache']} ms (in turns) at {t['geometry']}; line_cache {t['ms']['line_cache']:.4f} "
        f"ms = {b / t['ms']['line_cache']:.1%} of the bound, max_abs_err={lc_e:.3g}; "
        f"{lc.line_cache_residency(tf, t['geometry']['strip_rows'], t['geometry']['panel_cols'], p, device)} "
        f"line-cache CTAs resident per SM [{card}]")
    assert lc_e <= ATOL
    errs["line_cache"] = max(errs["line_cache"], lc_e)
    del want, t
    kernels["tile_pass"] = dict(
        name="tile_pass", route="cuda", source="stencilstream_tpu_torch/csrc/tile_pass.cu",
        replaces="stencilstream_tpu/backends/strip_pass.py:535", launches=totals["tile_pass"],
        max_abs_err=max(errs["tile_pass"], path_errs["tile_pass"], e), ms=ms, plain_ms=plain_ms,
        bound_ms=b, bound_by=by, library_ms=None,
        workload=f"hotspot 8192x8192, one pass of p={p}, tile {tile}",
    )
    del cell

    # Conway 8192^2, one pass at the main path's p and tile: 1 B read and 1 B
    # written per cell (no single PyTorch call computes it).
    cw_cfg = runs["conway 8192^2 auto"].resolved_config
    p, tile = cw_cfg["iters_per_pass"], (cw_cfg["tile_rows"], cw_cfg["tile_cols"])
    soup = torch.tensor(np.random.default_rng(8).random((8192, 8192)) < 0.35, device=device)
    life = conway.ConwayKernel()
    kw = dict(i_start=0, offset=0, n_iterations=p, iters_per_pass=p)
    ms = cuda_ms(lambda: tp.tile_pass(soup, life, False, tile=tile, **kw), 10)
    plain_ms = cuda_ms(lambda: tp.tile_pass_plain(soup, life, False, **kw), 2)
    e = max_err(tp.tile_pass(soup, life, False, tile=tile, **kw), tp.tile_pass_plain(soup, life, False, **kw))
    b, by = bound(2 * cells, 0)
    log(f"  tile_pass conway 8192x8192 tile={tile} p={p}: kernel {ms:.4f} ms = {b / ms:.1%} of its bound "
        f"{b:.4f} ms ({by}, 2 B/cell), plain {plain_ms:.4f} ms, library none: no single PyTorch call, "
        f"max_abs_err={e:.3g}; {tp.tile_pass_residency(life, tile, p, device)} CTAs resident per SM "
        f"(law: {TILE_LAW[2][2]}) [{card}]")
    assert e == 0
    # Beside it, the line cache on the same pass: the byte-cell path.
    want = tp.tile_pass_plain(soup, life, False, **kw)
    t = in_turns(soup, life, False, tile, p, limits, 10)
    lc_e = max(max_err(t["out"]["line_cache"], want), max_err(t["out"]["tile_pass"], want))
    log(f"  conway 8192x8192 p={p}: tile_pass {t['times']['tile_pass']} ms, line_cache "
        f"{t['times']['line_cache']} ms (in turns) at {t['geometry']}; line_cache {t['ms']['line_cache']:.4f} "
        f"ms = {b / t['ms']['line_cache']:.1%} of the bound, max_abs_err={lc_e:.3g}; "
        f"{lc.line_cache_residency(life, t['geometry']['strip_rows'], t['geometry']['panel_cols'], p, device)} "
        f"line-cache CTAs resident per SM [{card}]")
    assert lc_e == 0
    del soup, want, t

    # One Jacobi5 8192^2 pass of p=8, the tile-pass and line-cache kernels
    # in turns on the same input, and p conv2d calls.
    j5 = jacobi.make_kernel("jacobi5_general", JACOBI5_COEFS)
    x = torch.tensor(np.random.default_rng(9).random((8192, 8192), np.float32), device=device)
    tile_cfg = runs["jacobi5 8192^2 auto"].resolved_config
    lc_cfg = runs["jacobi5 8192^2 tiling linecache"].resolved_config
    p = lc_cfg["iters_per_pass"]
    assert tile_cfg["iters_per_pass"] == p, (tile_cfg, lc_cfg)
    kw = dict(i_start=0, offset=0, n_iterations=p, iters_per_pass=p)
    tile = (tile_cfg["tile_rows"], tile_cfg["tile_cols"])
    t = in_turns(x, j5, 0.0, tile, p, limits, 20)
    geometry, turns, jac_ms = t["geometry"], t["times"], t["ms"]
    assert geometry == {k: lc_cfg[k] for k in geometry}, (geometry, lc_cfg)
    jac_plain_ms = cuda_ms(lambda: tp.tile_pass_plain(x, j5, 0.0, **kw), 2)
    # The yardstick with cuDNN's default choice of algorithm, then with
    # `cudnn.benchmark`, whose first call per shape times the candidates and
    # keeps the fastest (cuda_ms's warm-up call); the tuned time is reported.
    lib_default_ms = cuda_ms(lambda: library_jacobi(x, p), 10)
    torch.backends.cudnn.benchmark = True
    lib_ms = cuda_ms(lambda: library_jacobi(x, p), 10)
    plain = tp.tile_pass_plain(x, j5, 0.0, **kw)
    lib_err = float((library_jacobi(x, p) - plain).abs().max())
    timed_err = {k: max_err(out, plain) for k, out in t["out"].items()}
    log(f"  jacobi5 8192x8192 p={p}: tile_pass {turns['tile_pass']} ms, line_cache {turns['line_cache']} "
        f"ms (in turns), plain {jac_plain_ms:.4f} ms, {p} x conv2d {lib_ms:.4f} ms tuned "
        f"({lib_default_ms:.4f} ms with cuDNN's default choice); conv2d against plain "
        f"max_abs_err={lib_err:.3g} (tol {LIBRARY_ATOL}), kernels against plain {timed_err} [{card}]")
    assert lib_err <= LIBRARY_ATOL and max(timed_err.values()) <= JACOBI_ATOL
    jac_bound, jac_by = bound(8 * cells, j5.n_operations * p * cells)
    for name in ("tile_pass", "line_cache"):
        log(f"  {name} jacobi5: {jac_ms[name]:.4f} ms = {jac_bound / jac_ms[name]:.1%} of its bound "
            f"{jac_bound:.4f} ms ({jac_by}) [{card}]")
    # What really resides per SM, against what the config law counted on.
    n_ctas = -(-8192 // geometry["panel_cols"]) * -(-8192 // geometry["segment_rows"])
    per_sm = lc.line_cache_residency(j5, geometry["strip_rows"], geometry["panel_cols"], p, device)
    law_per_sm = lc.ctas_per_sm(
        lc.line_cache_smem_bytes(geometry["strip_rows"], geometry["panel_cols"], 1, p, 4, 0), limits,
        lc.law_entry(4)[3],
    )
    log(f"  tile_pass jacobi5 tile={tile} p={p}: {tp.tile_pass_residency(j5, tile, p, device)} CTAs "
        f"resident per SM by the CUDA occupancy calculator (law: {TILE_LAW[8][2]})")
    log(f"  line_cache {geometry}: {n_ctas} CTAs, {per_sm} resident per SM by the CUDA occupancy "
        f"calculator (the law counted {law_per_sm}): {n_ctas / (per_sm * limits.sm_count):.3f} waves")
    kernels["line_cache"] = dict(
        name="line_cache", route="cuda", source="stencilstream_tpu_torch/csrc/line_cache.cu",
        replaces="stencilstream_tpu/backends/line_cache.py:375", launches=totals["line_cache"],
        max_abs_err=max(errs["line_cache"], path_errs["line_cache"], timed_err["line_cache"]),
        ms=jac_ms["line_cache"], plain_ms=jac_plain_ms, bound_ms=jac_bound, bound_by=jac_by,
        library_ms=lib_ms, workload=f"jacobi5_general 8192x8192, one pass of p={p}, {geometry}",
    )
    del x, plain, t

    # The resident grid at HotSpot 1024^2, n=1000 (no single PyTorch call).
    n_mono = 1000
    cell = hotspot_cell((1024, 1024), 7, device)
    tf = hotspot.derive_coefficients(1024, 1024)
    ms = cuda_ms(lambda: mt.monotile(cell, tf, hz, offset=0, n_iterations=n_mono), 5)
    plain_ms = cuda_ms(lambda: mt.monotile_plain(cell, tf, hz, offset=0, n_iterations=n_mono), 1)
    cells = 1024 * 1024
    mono_bound, mono_by = bound(12 * cells, tf.n_operations * n_mono * cells)
    plan = mt.monotile_plan(1024, 1024, 1, 12, limits)
    log(f"  monotile hotspot 1024x1024 n={n_mono} (band {plan.band}, q={plan.q}, {plan.threads} threads): "
        f"kernel {ms:.4f} ms ({cells * n_mono / ms / 1e6:.3f} GCell/s) = {mono_bound / ms:.1%} of its bound "
        f"{mono_bound:.4f} ms ({mono_by}), plain {plain_ms:.4f} ms [{card}]")
    # Beside it, for information: the same run through `tiling` (the tile
    # pass, host loop of ceil(n/p) passes); `auto` keeps the resident grid.
    grid = Grid(cell)
    tiling_out, update = hotspot.run(grid, n_mono, backend="tiling")
    tiling_ms = cuda_ms(lambda: hotspot.run(grid, n_mono, backend="tiling"), 3)
    mono_out, _ = hotspot.run(grid, n_mono, backend="monotile")
    log(f"  hotspot 1024x1024 n={n_mono} through tiling {update.resolved_config}: {tiling_ms:.4f} ms "
        f"({cells * n_mono / tiling_ms / 1e6:.3f} GCell/s, host loop included) against the resident "
        f"grid's {ms:.4f} ms; the two agree to {max_err(tiling_out.arrays, mono_out.arrays):.3g} [{card}]")
    assert max_err(tiling_out.arrays, mono_out.arrays) <= ATOL
    del grid, tiling_out, mono_out
    kernels["monotile"] = dict(
        name="monotile", route="cuda", source="stencilstream_tpu_torch/csrc/monotile.cu",
        replaces="stencilstream_tpu/backends/monotile.py:253", launches=totals["monotile"],
        max_abs_err=max(errs["monotile"], path_errs["monotile"]), ms=ms, plain_ms=plain_ms,
        bound_ms=mono_bound, bound_by=mono_by, library_ms=None,
        workload=f"hotspot 1024x1024, n={n_mono} in one launch",
    )

    # Beside it: Jacobi5 on the resident grid.
    y = torch.tensor(np.random.default_rng(10).random((1024, 1024), np.float32), device=device)
    ms = cuda_ms(lambda: mt.monotile(y, j5, 0.0, offset=0, n_iterations=n_mono), 5)
    plain_ms = cuda_ms(lambda: mt.monotile_plain(y, j5, 0.0, offset=0, n_iterations=n_mono), 1)
    lib_ms = cuda_ms(lambda: library_jacobi(y, n_mono), 2)
    b, by = bound(8 * cells, j5.n_operations * n_mono * cells)
    plan = mt.monotile_plan(1024, 1024, 1, 8, limits)
    log(f"  monotile jacobi5 1024x1024 n={n_mono} (band {plan.band}, q={plan.q}, {plan.threads} threads): "
        f"kernel {ms:.4f} ms = {b / ms:.1%} of its bound "
        f"{b:.4f} ms ({by}), plain {plain_ms:.4f} ms, {n_mono} x conv2d {lib_ms:.4f} ms tuned [{card}]")

    # The same kernels on bfloat16 cells: one more row each in the
    # `kernels` line.
    for k, row in narrow_kernel_rows(runs, path_counts, device, card, limits, n_mono).items():
        kernels[f"{k}_bf16"] = dict(name=f"{k}_bf16", route="cuda", source=kernels[k]["source"],
                                    replaces=kernels[k]["replaces"], **row)
        kernels[f"{k}_bf16"]["max_abs_err"] = max(row["max_abs_err"], errs[k], path_errs[k])

    fdtd_kernels = fdtd_kernel_rows(runs, path_counts, fdtd_outs, device, card, n_mono)
    log("fdtd kernels: " + json.dumps(fdtd_kernels))
    for row in fdtd_kernels.values():
        kernels[row["kernel"]]["max_abs_err"] = max(kernels[row["kernel"]]["max_abs_err"], row["max_abs_err"])
    kernels["tile_pass_extended"] = extended_kernel_row(multi_runs, device, card)
    kernels["tile_pass_extended"].update(
        launches=extended_launches,
        max_abs_err=max(kernels["tile_pass_extended"]["max_abs_err"], errs["tile_pass_extended"], multi_err),
    )
    conv_kernels = convection_kernel_rows(conv_runs, conv_counts, conv_outs, device, card)
    log("convection kernels: " + json.dumps(conv_kernels))
    for row in conv_kernels.values():
        kernels[row["kernel"]]["max_abs_err"] = max(kernels[row["kernel"]]["max_abs_err"], row["max_abs_err"])
    del conv_outs
    log(f"phase 5 done at {time.perf_counter() - t_start:.1f} s")

    # Phase 6: the experiments/ microbenchmarks' kernels.
    log("experiments/ kernels:")
    micro_rows = experiments_phase(device, card, totals)
    log(f"phase 6 done at {time.perf_counter() - t_start:.1f} s")

    order = ("tile_pass", "monotile", "line_cache", "tile_pass_bf16", "monotile_bf16", "line_cache_bf16",
             "tile_pass_extended")
    log(json.dumps({"kernels": [kernels[k] for k in order] + micro_rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
