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
   (where the plan's q falls back to 1), and as a single CTA;
4. drive the main paths through the entry points a user calls, each with
   the kernels' launch counters set to 0 just before it and read just
   after: ``hotspot.run(..., backend="auto")`` at 1024^2 (monotile) and
   8192^2 (tiling); ``jacobi.run`` of Jacobi5 at 8192^2 with
   ``backend="tiling", window_mode="linecache"`` (only the line-cache
   kernel) and through ``auto`` (tiling); Jacobi5 at 1024^2 through
   ``auto`` (monotile); Conway on a random 8192^2 soup through ``auto``.
   Then hold each path against the plain ``reference`` backend at a
   reduced n;
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
   resident per SM against what the config laws counted.

The line before the last is a JSON object describing each kernel at one
workload that stays the same from run to run (tile pass: HotSpot 8192^2;
resident grid: HotSpot 1024^2; line cache: Jacobi5 8192^2), with its bound:
the larger of the bytes it must move over 3.35 TB/s and its float32
operations (the transition function's ``n_operations``, a fused
multiply-add counted as two) over 67 TFLOP/s (H100 SXM at 700 W). The last
line is ``{"ok": true, "device": {...}}``. The port imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
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

#: H100 SXM peaks (NVIDIA's data sheet, 700 W): HBM bytes/s and float32
#: FLOP/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

#: (shape, q) of the resident grid's band checks: one-row bands, 8-row
#: bands with a ragged last band of 6 rows, 5-row bands.
MONO_BANDS = [((37, 53), 1), ((1030, 64), 1), ((1030, 64), 2), ((1030, 64), 4),
              ((600, 40), 1), ((600, 40), 2), ((600, 40), 4)]

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


def op_case(op, shape, seed, device, iteration=0):
    """(cell, transition function, halo cell, tolerance) for a device
    functor: non-zero halos (HotSpot 5.0 and 0.25 for the power, Jacobi
    5.0); the probe's cells sit at ``iteration``."""
    import torch

    from stencilstream_tpu_torch import probe
    from stencilstream_tpu_torch.models import conway, hotspot, jacobi

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
    grid = probe.make_probe_grid(*shape, iteration, device=device)
    return grid.arrays, probe.ProbeKernel(), probe.probe_halo_cell(), 0.0


def max_err(a, b) -> float:
    from stencilstream_tpu_torch.core.cell import cell_leaves

    return max(
        float((x.double() - y.double()).abs().max()) for x, y in zip(cell_leaves(a), cell_leaves(b))
    )


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


def bound(n_bytes: float, n_flops: float) -> tuple[float, str]:
    """The least time, in ms, the card could take: the larger of the bytes
    over HBM's rate and the operations over float32's."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


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

    errs = {"tile_pass": 0.0, "monotile": 0.0, "line_cache": 0.0}
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
    # an SM, from iteration 3 with n*k not a multiple of q (but for the
    # probe at q=2), so the last group is short: 8-row bands with a ragged
    # last band of 6 rows (1030), 5-row bands (600), one-row bands (37);
    # every probe cell must stay Normal. Then a single CTA that holds the
    # whole grid, q=4, from iteration 2.
    for seed, op in enumerate(["hotspot", "jacobi5_general", "probe"], start=600):
        for shape, q in MONO_BANDS:
            cell, tf, halo, tol = op_case(op, shape, seed, device, iteration=3)
            n = 3 if op == "probe" else 5
            band = -(-shape[0] // limits.sm_count)
            plan = MonotilePlan(band, -(-shape[0] // band), 0, q, MAX_THREADS)
            got = monotile(cell, tf, halo, offset=3, n_iterations=n, plan=plan)
            want = monotile_plain(cell, tf, halo, offset=3, n_iterations=n)
            torch.cuda.synchronize()
            check(errs, "monotile", f"{op} {shape} band={band} q={q} offset=3 n={n}", got, want, tol)
            if op == "probe":
                assert int(got.status.abs().max()) == probe.NORMAL, "probe cells flagged Invalid"
        cell, tf, halo, tol = op_case(op, (37, 53), seed, device, iteration=2)
        plan = MonotilePlan(37, 1, 0, 4, MAX_THREADS)
        got = monotile(cell, tf, halo, offset=2, n_iterations=7, plan=plan)
        want = monotile_plain(cell, tf, halo, offset=2, n_iterations=7)
        torch.cuda.synchronize()
        check(errs, "monotile", f"{op} (37, 53) one CTA q=4 offset=2 n=7", got, want, tol)
        if op == "probe":
            assert int(got.status.abs().max()) == probe.NORMAL, "probe cells flagged Invalid"

    # Every other functor on every kernel.
    others = [*sorted(jacobi.VARIANTS), "conway", "probe"]
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
            if op == "probe":
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
            if op == "probe":
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
        if op == "hotspot":
            assert got.power is cell.power, "invariant field must be passed through"
        if op == "probe":
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
    from stencilstream_tpu_torch.models import conway, hotspot, jacobi
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

    # Phase 3: kernels against their plain versions.
    log("kernel checks:")
    errs = check_kernels(device)
    log(f"phase 3 done at {time.perf_counter() - t_start:.1f} s")

    # Phase 4: the main paths, through the entry points a user calls.
    counters = {"tile_pass": tp, "monotile": mt, "line_cache": lc}
    # name: (reduced n for the reference check, tolerance, kernels it must launch)
    checks = {
        "hotspot 1024^2 auto": (20, ATOL, {"monotile"}),
        "hotspot 8192^2 auto": (12, ATOL, {"tile_pass"}),
        "jacobi5 8192^2 tiling linecache": (12, JACOBI_ATOL, {"line_cache"}),
        "jacobi5 8192^2 auto": (12, JACOBI_ATOL, {"tile_pass"}),
        "jacobi5 1024^2 auto": (20, JACOBI_ATOL, {"monotile"}),
        "conway 8192^2 auto": (12, 0.0, {"tile_pass"}),
    }
    paths = main_paths(device)
    assert set(paths) == set(checks), sorted(paths)
    totals = dict.fromkeys(counters, 0)
    path_errs = dict.fromkeys(counters, 0.0)
    runs = {}
    for name, (grid, run, n, options) in paths.items():
        n_small, tol, expect = checks[name]
        for module in counters.values():
            module.launches = 0
        out, update = run(grid, n, **options)
        counts = {k: m.launches for k, m in counters.items()}
        runs[name] = update
        launched = {k for k, c in counts.items() if c}
        log(f"  {name}, n={n}: -> {getattr(update, 'resolved_backend', 'tiling')} "
            f"{update.resolved_config or ''}; launches {counts}; walltime {update.get_walltime():.6f} s, "
            f"{grid.shape[0] * grid.shape[1] * n / update.get_walltime() / 1e9:.3f} GCell/s "
            f"(host clock, build excluded) [{card}]")
        assert launched == expect, (name, counts)
        for k in counters:
            totals[k] += counts[k]
        field = out.arrays.temp if name.startswith("hotspot") else out.arrays
        assert tuple(field.shape) == grid.shape, name
        assert field.dtype == torch.bool or bool(torch.isfinite(field).all()), name
        if name.startswith("conway"):
            assert field.dtype == torch.bool and 0 < int(field.sum()) < field.numel(), name
        # The same path at a reduced n against the plain reference backend.
        got, _ = run(grid, n_small, **options)
        want, _ = run(grid, n_small, backend="reference")
        e = max_err(got.arrays, want.arrays)
        for k in expect:
            path_errs[k] = max(path_errs[k], e)
        log(f"  {name}, n={n_small}: against reference max_abs_err={e:.3g} (tol {tol})")
        assert e <= tol, (name, e)
        del out, got, want
    log(f"main path launches: {totals}")
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
    c = JACOBI5_COEFS
    w = torch.tensor([[0, c[0], 0], [c[1], c[4], c[3]], [0, c[2], 0]], dtype=torch.float32,
                     device=device).view(1, 1, 3, 3)

    def library_jacobi(y, steps):
        y = y.view(1, 1, *y.shape)
        for _ in range(steps):
            y = torch.nn.functional.conv2d(y, w, padding=1)
        return y.view(y.shape[2:])

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
    log(f"phase 5 done at {time.perf_counter() - t_start:.1f} s")

    order = ("tile_pass", "monotile", "line_cache")
    log(json.dumps({"kernels": [kernels[k] for k in order]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
