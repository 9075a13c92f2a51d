#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (stencilstream_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit code when it fails:

1. require a CUDA card; print its name and power limit (nvidia-smi);
2. build the CUDA kernels from ``stencilstream_tpu_torch/csrc`` and print
   how long the build took and what ptxas reports;
3. hold each kernel against its plain PyTorch version on the card: odd
   shapes, a grid smaller than a tile, ``n % p != 0``, a non-zero iteration
   offset and a non-zero halo value;
4. drive the main path, ``hotspot.run(grid, n, backend="auto")``, at 1024^2
   (resolves to ``monotile``) and at 8192^2 (resolves to ``tiling``), with
   the kernels' launch counters reset just before and read just after; then
   hold the path against the plain ``reference`` backend at a reduced n;
5. time each kernel and its plain version with CUDA events at the main
   path's shapes.

The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``. The port imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np

#: Kernel against plain version, temperatures in [70, 90]: both evaluate the
#: same float32 operations in the same order (the kernels are built without
#: FMA contraction, and the one fused multiply-add is exact in the plain
#: version up to a float64 double rounding), so they agree to a few ulps
#: (an ulp at 80 is 7.6e-6). 1e-4 admits that and nothing else: with the
#: strong coefficients below, one missing or extra iteration moves
#: temperatures by ~1e-1, and a wrong halo or coordinate by more.
ATOL = 1e-4


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


def max_err(a, b) -> float:
    return float((a.temp.double() - b.temp.double()).abs().max())


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


def check_kernels(device, strong, halo) -> dict:
    """Phase 3: each kernel against its plain version on the card."""
    import torch

    from stencilstream_tpu_torch.backends.monotile import monotile, monotile_plain
    from stencilstream_tpu_torch.backends.tile_pass import tile_pass, tile_pass_plain

    errs = {"tile_pass": 0.0, "monotile": 0.0}
    # (shape, tile, iters_per_pass, i_start, offset, n): partial passes,
    # non-zero offsets, odd shapes and a grid smaller than one tile.
    tile_cases = [
        ((37, 53), (16, 32), 3, 3, 3, 5),
        ((37, 53), (64, 64), 4, 7, 3, 5),     # second pass: 1 of 4 steps
        ((20, 24), (64, 64), 8, 0, 0, 8),     # grid smaller than a tile
        ((1000, 1000), (64, 64), 8, 11, 10, 13),
        ((1000, 1000), (32, 64), 6, 5, 5, 100),
        ((8192, 8192), (64, 64), 8, 0, 0, 1000),
    ]
    for seed, (shape, tile, p, i_start, offset, n) in enumerate(tile_cases):
        cell = hotspot_cell(shape, seed, device)
        kw = dict(i_start=i_start, offset=offset, n_iterations=n, iters_per_pass=p)
        got = tile_pass(cell, strong, halo, tile=tile, **kw)
        want = tile_pass_plain(cell, strong, halo, **kw)
        torch.cuda.synchronize()
        e = max_err(got, want)
        moved = max_err(want, cell)
        errs["tile_pass"] = max(errs["tile_pass"], e)
        log(f"  tile_pass {shape} tile={tile} p={p} i_start={i_start} offset={offset} n={n}: "
            f"max_abs_err={e:.3g} (tol {ATOL}; the pass moved cells by up to {moved:.3g})")
        assert e <= ATOL, f"tile-pass kernel disagrees with its plain version: {e}"
        assert got.power is cell.power, "invariant field must be passed through"
    mono_cases = [((37, 53), 3, 7), ((20, 24), 0, 1), ((1000, 1000), 5, 64), ((1024, 1024), 2, 200)]
    for seed, (shape, offset, n) in enumerate(mono_cases, start=100):
        cell = hotspot_cell(shape, seed, device)
        got = monotile(cell, strong, halo, offset=offset, n_iterations=n)
        want = monotile_plain(cell, strong, halo, offset=offset, n_iterations=n)
        torch.cuda.synchronize()
        e = max_err(got, want)
        moved = max_err(want, cell)
        errs["monotile"] = max(errs["monotile"], e)
        log(f"  monotile {shape} offset={offset} n={n}: max_abs_err={e:.3g} "
            f"(tol {ATOL}; the run moved cells by up to {moved:.3g})")
        assert e <= ATOL, f"resident-grid kernel disagrees with its plain version: {e}"
    return errs


def main() -> int:
    import torch

    # Phase 1: the card.
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    from stencilstream_tpu_torch import Grid
    from stencilstream_tpu_torch.backends import cuda_lib
    from stencilstream_tpu_torch.backends import monotile as mt
    from stencilstream_tpu_torch.backends import tile_pass as tp
    from stencilstream_tpu_torch.models import hotspot

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
    f32 = np.float32
    strong = hotspot.HotspotKernel(Rx_1=f32(0.1), Ry_1=f32(0.1), Rz_1=f32(0.05), Cap_1=f32(0.5))
    halo = hotspot.HotspotCell(temp=5.0, power=0.25)
    log("kernel checks:")
    errs = check_kernels(device, strong, halo)

    # Phase 4: the main path, through the entry point a user calls.
    shapes = {"monotile": (1024, 1024, 1000), "tiling": (8192, 8192, 200)}
    grids = {
        name: Grid(hotspot_cell((h, w), 7, device)) for name, (h, w, _) in shapes.items()
    }
    tp.launches = 0
    mt.launches = 0
    main_runs = {}
    for name, (h, w, n) in shapes.items():
        out, update = hotspot.run(grids[name], n, backend="auto")
        main_runs[name] = (out, update)
    counts = {"tile_pass": tp.launches, "monotile": mt.launches}
    log(f"main path launches: {counts}")
    for name, (h, w, n) in shapes.items():
        out, update = main_runs[name]
        temp = out.arrays.temp
        assert update.resolved_backend == name, (name, update.resolved_backend)
        assert tuple(temp.shape) == (h, w) and bool(torch.isfinite(temp).all()), name
        rate = h * w * n / update.get_walltime() / 1e9
        config = update.resolved_config
        log(f"  {h}x{w}, n={n}: auto -> {update.resolved_backend} {config or ''}; "
            f"walltime {update.get_walltime():.6f} s, {rate:.3f} GCell/s "
            f"(host clock, first call, build excluded) [{card}]")
    assert counts["tile_pass"] > 0 and counts["monotile"] > 0, counts

    path_errs = {}
    for name, (h, w, _) in shapes.items():
        n_small = 20 if name == "monotile" else 12  # 12 = one full and one partial pass of p=8
        got, _ = hotspot.run(grids[name], n_small, backend="auto")
        want, _ = hotspot.run(grids[name], n_small, backend="reference")
        e = max_err(got.arrays, want.arrays)
        path_errs[name] = e
        log(f"  {h}x{w}, n={n_small}: auto vs reference max_abs_err={e:.3g} (tol {ATOL})")
        assert e <= ATOL, (name, e)

    # Phase 5: kernel and plain times at the main path's shapes.
    kernels = []
    n_mono = shapes["monotile"][2]
    cell = grids["monotile"].arrays
    tf = hotspot.derive_coefficients(1024, 1024)
    hz = hotspot.HotspotCell(temp=0.0, power=0.0)
    ms = cuda_ms(lambda: mt.monotile(cell, tf, hz, offset=0, n_iterations=n_mono), 5)
    plain_ms = cuda_ms(lambda: mt.monotile_plain(cell, tf, hz, offset=0, n_iterations=n_mono), 1)
    log(f"  monotile 1024x1024 n={n_mono}: kernel {ms:.4f} ms ({1024 * 1024 * n_mono / ms / 1e6:.3f} "
        f"GCell/s), plain {plain_ms:.4f} ms ({1024 * 1024 * n_mono / plain_ms / 1e6:.3f} GCell/s) [{card}]")
    kernels.append(dict(
        name="monotile", route="cuda", source="stencilstream_tpu_torch/csrc/monotile.cu",
        replaces="stencilstream_tpu/backends/monotile.py:253", launches=counts["monotile"],
        max_abs_err=max(errs["monotile"], path_errs["monotile"]), ms=ms, plain_ms=plain_ms,
    ))
    cell = grids["tiling"].arrays
    tf = hotspot.derive_coefficients(8192, 8192)
    config = main_runs["tiling"][1].resolved_config
    p, tile = config["iters_per_pass"], (config["tile_rows"], config["tile_cols"])
    kw = dict(i_start=0, offset=0, n_iterations=p, iters_per_pass=p)
    ms = cuda_ms(lambda: tp.tile_pass(cell, tf, hz, tile=tile, **kw), 10)
    plain_ms = cuda_ms(lambda: tp.tile_pass_plain(cell, tf, hz, **kw), 2)
    log(f"  tile_pass 8192x8192 tile={tile} p={p}: kernel {ms:.4f} ms "
        f"({8192 * 8192 * p / ms / 1e6:.3f} GCell/s), plain {plain_ms:.4f} ms "
        f"({8192 * 8192 * p / plain_ms / 1e6:.3f} GCell/s) [{card}]")
    kernels.append(dict(
        name="tile_pass", route="cuda", source="stencilstream_tpu_torch/csrc/tile_pass.cu",
        replaces="stencilstream_tpu/backends/strip_pass.py:535", launches=counts["tile_pass"],
        max_abs_err=max(errs["tile_pass"], path_errs["tiling"]), ms=ms, plain_ms=plain_ms,
    ))

    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
