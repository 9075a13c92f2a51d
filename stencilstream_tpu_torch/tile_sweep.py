"""Geometry of the tile-pass, line-cache and resident-grid kernels, timed on one NVIDIA card.

    python -m stencilstream_tpu_torch.tile_sweep [--out sweep.jsonl]
        [--parts grid,sass,linecache,linecache-sass,monotile] [--ops hotspot,jacobi5,conway,probe,fdtd]
        [--passes 2,4,8] [--strips 16,32,64] [--windows 64,128] [--waves 1,2,3]
        [--qs 1,2,4,8] [--threads 1024,512]

Five parts, each printing one JSON line per measurement:

* ``grid``: one pass at each (tile, p) whose window fits one block's shared
  memory, for HotSpot (12 B a cell in shared memory), Jacobi5 (8 B), Conway
  (2 B) and the probe (40 B) at 8192^2, and FDTD's coef cell (48 B) at
  1024^2 on smaller tiles (:data:`FDTD_TILES`; also its lut and render
  cells, ``fdtd_lut`` and ``fdtd_render``), with the CTAs per SM that
  the CUDA occupancy calculator reports, the time of a pass with no step
  active (staging and write-back alone, ``copy_ms``), and the cells the
  thread map computes per useful cell-step (:func:`thread_map_work`).
  Compare ``ms_per_iteration``; ``device_ms`` is the kernel's own device
  time (``torch.profiler``), which a pass shorter than its host call
  (FDTD's) needs, since back-to-back calls then leave the card idle.
* ``sass``: the kernel library disassembled with ``cuobjdump -sass``: for
  each functor, the loops of the tile-pass kernel that load and store
  shared memory and hold no other such loop (the run loops of the interior
  and the edge sub-steps), with their instructions, shared loads (``LDS``)
  and stores (``STS``), and the shared loads per cell-step (``LDS`` x
  variant fields / ``STS``).
* ``linecache``: one line-cache pass at each (strip, window, p, waves) whose
  CTA fits one block's shared memory, same cases and size, the panel being
  the window less both halos and the segments those of the law
  (:func:`.backends.line_cache.segment_rows`) for ``waves`` waves of CTAs at
  the CTAs per SM that the occupancy calculator reports; with the time of a
  pass with no step active (``copy_ms``: staging and stores alone) and the
  lane-cells per useful cell-step (:func:`line_cache_work`).
* ``linecache-sass``: the run loops of the line-cache kernel, counted as
  for the tile pass (its level loop holds the interior and the edge run
  bodies together).
* ``monotile``: the resident-grid kernel, one call of n=1000 iterations, at
  each (threads per CTA, q) that fits: HotSpot and Jacobi5 at 1024^2, the
  probe at 600^2, FDTD's coef cell at 512^2 (:data:`MONO_SIZES`); one CTA
  of 1024 threads an SM, or
  two of 512 (bands half as tall), and q sub-steps per exchange with q*r
  at most the band. With the lane-cells the thread map computes per useful
  cell-step on an interior band (:func:`mono_work`). Compare
  ``us_per_substep``; :data:`.backends.monotile.MONO_LAW` records the best.

Every kernel result is held against the plain version (``max_abs_err``);
times are CUDA-event means over repeated launches after a warm-up. Needs a
CUDA card; there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import itertools
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from .backends import cuda_lib
from .core.cell import cell_leaves
from .backends import line_cache as lc
from .backends import monotile as mt
from .backends import tile_pass as tp
from .models import conway, fdtd, hotspot, jacobi
from .tdv import tdv_stream
from .trace_cells import JACOBI5_COEFS
from . import probe

__all__ = ["main", "line_cache_work", "mono_work", "run_loops", "thread_map_work", "TILES", "PASSES"]

#: Core tiles of the geometry sweep, heights a multiple of the run: widths a
#: multiple of the 32-lane warp, and widths whose window at a halo of 8
#: (p=8 at radius 1) is a multiple of it.
TILES = [(32, 64), (64, 64), (64, 96), (32, 128), (64, 128), (128, 64), (96, 96), (96, 128),
         (32, 192), (128, 128), (64, 256), (32, 256),
         (32, 112), (40, 112), (48, 112), (56, 112), (64, 112), (80, 112), (96, 112),
         (32, 240), (48, 240), (64, 240)]
#: Core tiles of FDTD's geometry sweep: its 48 B cells leave room for
#: windows of ~4.8k cells; one cell a thread, so heights need not be runs.
FDTD_TILES = [(8, 64), (8, 128), (16, 64), (16, 96), (16, 128), (16, 192), (24, 64), (24, 96),
              (24, 128), (32, 64), (32, 96), (32, 128), (48, 64), (64, 64)]
#: Iterations per pass of the geometry sweep.
PASSES = [2, 4, 6, 8, 12, 16]
SIZE = 8192
#: Grid side of the grid and line-cache sweeps where it is not SIZE: FDTD's
#: main path runs 1024^2.
SIZES = {"fdtd": 1024}
#: Strip heights and window widths (panel + both halos) of the line-cache
#: sweep: whole runs, and whole warps.
STRIPS = [16, 32, 64]
WINDOWS = [64, 96, 128, 160, 192, 256]
#: Grid side of each resident-grid case (the probe's 40 B a cell fit at 600^2).
MONO_SIZES = {"hotspot": 1024, "jacobi5": 1024, "probe": 600, "fdtd": 512}
#: Device functor of each swept case, as ptxas names its instantiation.
FUNCTORS = {"hotspot": "HotspotOp", "jacobi5": "Jacobi5GeneralOp", "conway": "ConwayOp", "probe": "ProbeOp",
            "fdtd": "FdtdCoefOp"}


def fdtd_case(device, size, resolver="coef"):
    """FDTD's cell of a resolver on the mono-benchmark's geometry at size^2,
    its fields random (a wave in flight) and its materials the ring's."""
    rng = np.random.default_rng(6)
    parameters = fdtd.Parameters.from_json(fdtd.mono_benchmark(size))
    res = fdtd.RESOLVERS[resolver](parameters)
    cell = fdtd.init_grid(parameters, res, device=device).arrays
    for f in ("ex", "ey", "hz", "hz_sum"):
        setattr(cell, f, torch.tensor(rng.uniform(-1, 1, (size, size)).astype(np.float32), device=device))
    return cell, fdtd.make_kernel(parameters, res), res.halo_cell()


def cases(device, size=SIZE, ops=("hotspot", "jacobi5", "conway", "probe")):
    """name -> (cell, transition function, halo cell) at size^2 (FDTD's at
    its own size, :data:`SIZES`) for each of ``ops``."""
    rng = np.random.default_rng(5)
    shape = (size, size)
    hs = hotspot.HotspotCell(
        temp=torch.tensor(rng.uniform(70, 90, shape).astype(np.float32), device=device),
        power=torch.tensor(rng.uniform(0, 1e-3, shape).astype(np.float32), device=device),
    )
    work = {
        "hotspot": (hs, hotspot.derive_coefficients(*shape), hotspot.HotspotCell(temp=0.0, power=0.0)),
        "jacobi5": (
            torch.tensor(rng.random(shape, np.float32), device=device),
            jacobi.make_kernel("jacobi5_general", JACOBI5_COEFS), 0.0,
        ),
        "conway": (torch.tensor(rng.random(shape) < 0.35, device=device), conway.ConwayKernel(), False),
        "probe": (probe.make_probe_grid(*shape, 0, device=device).arrays, probe.ProbeKernel(),
                  probe.probe_halo_cell()),
    } if any(not op.startswith("fdtd") for op in ops) else {}
    for op in ops:
        if op.startswith("fdtd"):
            work[op] = fdtd_case(device, SIZES["fdtd"] if size == SIZE else size,
                                 "coef" if op == "fdtd" else op[len("fdtd_"):])
    return {op: work[op] for op in ops}


def thread_map_work(tile, halo: int, radius: int, run: int = tp.RUN_ROWS) -> tuple[float, float]:
    """What the kernel's thread map computes in one pass over one tile, per
    useful cell-step (core cells x halo/radius sub-steps): ``(lane-cells,
    window cells)``. Sub-step s computes the window narrowed by r*(s+1) per
    side; the lanes cover it in whole 32-column chunks and whole runs."""
    th, tw = tile
    steps = halo // radius
    lanes = window = 0
    for s in range(steps):
        h, w = th + 2 * (halo - radius * (s + 1)), tw + 2 * (halo - radius * (s + 1))
        window += h * w
        lanes += -(-h // run) * run * -(-w // tp.WARP) * tp.WARP
    useful = th * tw * steps
    return lanes / useful, window / useful


def line_cache_work(panel: int, halo: int, radius: int, strip: int, segment: int, warmup: int) -> float:
    """Lane-cells the line-cache kernel's thread map computes per useful
    cell-step (core cells x halo/radius levels) on a segment that is not
    the first: every level computes ``strip`` rows of its narrowing window
    in whole 32-column chunks, over the segment and its warm-up."""
    steps = halo // radius
    window = panel + 2 * halo
    lanes = sum(-(-(window - 2 * radius * s) // tp.WARP) * tp.WARP for s in range(1, steps + 1))
    walked = -(-(warmup + segment) // strip) * strip
    return lanes * walked / (panel * steps * segment)


def mono_work(band: int, q: int, radius: int, run: int) -> float:
    """Lane-cells the resident grid's thread map computes per useful
    cell-step on an interior band: sub-step j of a group of q computes the
    band plus (q-1-j)*r rows a side, in whole runs down each column."""
    rows = [band + 2 * radius * m for m in range(q)]
    return sum(-(-h // run) * run for h in rows) / (band * q)


def max_err(a, b) -> float:
    return max(float((x.double() - y.double()).abs().max()) for x, y in zip(cell_leaves(a), cell_leaves(b)))


def kernel_report(report: str, kernel: str) -> dict:
    """ptxas's registers and stack/spill line for each instantiation of
    ``kernel``, by functor name."""
    out, name = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if kernel in line else None
        elif name and ("Used" in line or "spill" in line):
            out.setdefault(name.split(kernel)[1][:24], []).append(line.split(":", 1)[-1].strip())
    return out


_SASS_INSTRUCTION = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);")
_BACKWARD_BRANCH = re.compile(r"\bBRA\b.*?(0x[0-9a-f]+)")


def run_loops(sass: str, functor: str, kernel: str = "tile_pass_kernel") -> list[dict]:
    """The run loops of ``functor``'s ``kernel`` in a ``cuobjdump -sass``
    listing: loops (spans closed by a backward branch) that load and store
    shared memory, copy nothing from global memory (``LDGSTS``) and hold no
    other such loop; ``instructions``, ``LDS`` and ``STS`` counted over the
    loop's body."""
    chunk = next((c for c in sass.split("Function : ")[1:]
                  if c.startswith(f"_ZN2ss{len(kernel)}{kernel}") and functor in c.split(None, 1)[0]), "")
    code = [(int(a, 16), op) for a, op in _SASS_INSTRUCTION.findall(chunk)]
    loops = []
    for addr, op in code:
        branch = _BACKWARD_BRANCH.search(op)
        if branch and int(branch.group(1), 16) < addr:
            body = [o for a, o in code if int(branch.group(1), 16) <= a <= addr]
            count = lambda pattern: sum(1 for o in body if re.search(pattern, o))  # noqa: E731
            loops.append(dict(span=(int(branch.group(1), 16), addr), instructions=len(body),
                              LDS=count(r"\bLDS"), STS=count(r"\bSTS"), LDGSTS=count(r"\bLDGSTS")))
    candidates = [lp for lp in loops if lp["LDS"] and lp["STS"] and not lp["LDGSTS"]]
    inner = [lp for lp in candidates
             if not any(o is not lp and lp["span"][0] <= o["span"][0] and o["span"][1] <= lp["span"][1]
                        for o in candidates)]
    return sorted(({k: v for k, v in lp.items() if k not in ("span", "LDGSTS")} for lp in inner),
                  key=lambda lp: lp["instructions"])


def timed(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps: int, attempts: int = 3) -> float:
    """Mean device time, in ms, of the package's kernels that ``fn()``
    launches, by ``torch.profiler`` over ``reps`` calls after a warm-up.
    Unlike :func:`timed` it leaves out the card's idle time between calls,
    which a kernel shorter than its host call leaves. A profiled window in
    which the profiler saw no kernel (it missed some early in a process) is
    profiled again, up to ``attempts`` times; 0 if it never sees one."""
    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(attempts):
        with torch.profiler.profile(activities=activities) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
                 for e in prof.key_averages() if "ss::" in e.key and "_kernel" in e.key)
        if us > 0:
            return us / 1e3 / reps
    return 0.0


def run_pass(cell, tf, halo, tile, p, n=None, tdv=None):
    """One pass of p iterations; with ``n=0`` no step is active, so the
    kernel only stages and writes back. ``tdv``: the call's TDV stream."""
    return tp.tile_pass(cell, tf, halo, i_start=0, offset=0, n_iterations=p if n is None else n,
                        iters_per_pass=p, tile=tile, tdv=tdv)


def run_line_cache(cell, tf, halo, strip, panel, segment, p, n=None, tdv=None):
    """One line-cache pass of p iterations; with ``n=0`` no step is active,
    so the kernel only stages and stores. ``tdv``: the call's TDV stream."""
    return lc.line_cache_pass(cell, tf, halo, i_start=0, offset=0, n_iterations=p if n is None else n,
                              iters_per_pass=p, strip_rows=strip, panel_cols=panel, segment_rows=segment,
                              tdv=tdv)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="tile_sweep", description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the JSON lines to this file")
    parser.add_argument("--passes", default=",".join(map(str, PASSES)), help="p values of the geometry sweep")
    parser.add_argument("--parts", default="grid,sass",
                        help="comma-separated: grid, sass, linecache, linecache-sass, monotile")
    parser.add_argument("--ops", default="hotspot,jacobi5,conway,probe",
                        help="ops of the grid sweeps (also: fdtd, FDTD's coef cell; fdtd_lut, fdtd_render)")
    parser.add_argument("--strips", default=",".join(map(str, STRIPS)), help="strips of the line-cache sweep")
    parser.add_argument("--windows", default=",".join(map(str, WINDOWS)), help="windows of the line-cache sweep")
    parser.add_argument("--waves", default="1,2,3,4", help="waves of CTAs the line-cache segments make")
    parser.add_argument("--qs", default="1,2,4,8", help="sub-steps per exchange of the monotile part")
    parser.add_argument("--threads", default="1024,512", help="threads per CTA of the monotile part")
    parser.add_argument("--mono-n", type=int, default=1000, help="iterations of one monotile call")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("tile_sweep: no CUDA device is available", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    parts = set(args.parts.split(","))
    lines = []

    def emit(record):
        record["card"] = card
        lines.append(json.dumps(record))
        print(lines[-1], flush=True)

    cuda_lib.library()
    limits = cuda_lib.device_limits(device)
    if "monotile" in parts:
        emit(dict(part="monotile-build", ptxas=kernel_report(cuda_lib.build()[2], "monotile_kernel")))
        for op in ("hotspot", "jacobi5", "probe", "fdtd"):
            if op not in args.ops.split(","):
                continue
            size = MONO_SIZES[op]
            cell, tf, halo = cases(device, size, ops=(op,))[op]
            r, k, n = tf.stencil_radius, tf.n_subiterations, args.mono_n
            cell_bytes = cuda_lib.cell_smem_bytes(cell, tf)
            stream = tdv_stream(tf, 0, n, device)
            want = mt.monotile_plain(cell, tf, halo, offset=0, n_iterations=n, tdv=stream)
            run = tp.RUN_ROWS if cuda_lib.op_info(tf.cuda_op)["n_variant"] == 1 else 1
            for threads in map(int, args.threads.split(",")):
                per_sm = mt.MAX_THREADS // threads
                band = max(r, -(-size // (limits.sm_count * per_sm)))
                for q in map(int, args.qs.split(",")):
                    smem = mt.monotile_smem_bytes(band, q, size, r, cell_bytes)
                    if q * r > band or smem > mt.smem_budget(limits, per_sm):
                        continue
                    plan = mt.MonotilePlan(band, -(-size // band), mt.monotile_smem_bytes(band, 1, size, r, cell_bytes),
                                           q, threads)
                    fn = lambda: mt.monotile(cell, tf, halo, offset=0, n_iterations=n, plan=plan, tdv=stream)  # noqa: E731
                    e = max_err(fn(), want)
                    ms = timed(fn, 5)
                    emit(dict(part="monotile", op=op, size=size, cell_bytes=cell_bytes, threads=threads, q=q,
                              band=band, n_ctas=plan.n_ctas, n=n, ms=ms, us_per_substep=ms * 1e3 / (n * k),
                              smem=smem, ctas_per_sm=mt.monotile_residency(tf, plan, size, device),
                              lane_cells_per_cell_step=mono_work(band, q, r, run), max_abs_err=e))
            del cell, want
        if parts == {"monotile"}:
            return _write(args.out, lines)
    work = cases(device, ops=tuple(args.ops.split(",")))
    plain_cache = {}

    def plain(op, p):
        if (op, p) not in plain_cache:
            plain_cache.clear()
            cell, tf, halo = work[op]
            plain_cache[(op, p)] = tp.tile_pass_plain(cell, tf, halo, i_start=0, offset=0,
                                                      n_iterations=p, iters_per_pass=p)
        return plain_cache[(op, p)]

    if "grid" in parts:
        emit(dict(part="build", ptxas=kernel_report(cuda_lib.build()[2], "tile_pass_kernel")))
        for op in args.ops.split(","):
            cell, tf, halo = work[op]
            cell_bytes = cuda_lib.cell_smem_bytes(cell, tf)
            run = tp.RUN_ROWS if cuda_lib.op_info(tf.cuda_op)["n_variant"] == 1 else 1
            for p in map(int, args.passes.split(",")):
                stream = tdv_stream(tf, 0, p, device)
                for tile in FDTD_TILES if op.startswith("fdtd") else TILES:
                    hp = tf.stencil_radius * p * tf.n_subiterations
                    smem = tp.tile_smem_bytes(*tile, hp, cell_bytes)
                    if smem > limits.smem_per_block or hp > min(tile):
                        continue
                    fn = lambda: run_pass(cell, tf, halo, tile, p, tdv=stream)  # noqa: E731
                    e = max_err(fn(), plain(op, p))
                    ms = timed(fn, 5)
                    dev_ms = device_ms(fn, 5)
                    copy_ms = timed(lambda: run_pass(cell, tf, halo, tile, p, 0), 5)
                    lanes, window = thread_map_work(tile, hp, tf.stencil_radius, run)
                    emit(dict(part="grid", op=op, size=cell_leaves(cell)[0].shape[0], cell_bytes=cell_bytes,
                              tile=list(tile), p=p, ms=ms, device_ms=dev_ms, ms_per_iteration=ms / p,
                              device_ms_per_iteration=dev_ms / p, copy_ms=copy_ms, smem=smem,
                              ctas_per_sm=tp.tile_pass_residency(tf, tile, p, device),
                              lane_cells_per_cell_step=lanes, window_cells_per_cell_step=window,
                              max_abs_err=e))
    if "linecache" in parts:
        emit(dict(part="linecache-build", ptxas=kernel_report(cuda_lib.build()[2], "line_cache_kernel")))
        for op in args.ops.split(","):
            cell, tf, halo = work[op]
            r = tf.stencil_radius
            variant, invariant = cuda_lib.cell_field_bytes(cell, tf)
            for p in map(int, args.passes.split(",")):
                stream = tdv_stream(tf, 0, p, device)
                steps = p * tf.n_subiterations
                hp = r * steps
                for strip, window, waves in itertools.product(
                    map(int, args.strips.split(",")), map(int, args.windows.split(",")),
                    map(int, args.waves.split(",")),
                ):
                    panel = window - 2 * hp
                    smem = lc.line_cache_smem_bytes(strip, panel, r, steps, variant, invariant)
                    if panel < lc.WARP or smem > limits.smem_per_block or strip < 2 * r:
                        continue
                    per_sm = lc.line_cache_residency(tf, strip, panel, p, device)
                    warmup = lc.warmup_rows(r, steps, strip)
                    size = cell_leaves(cell)[0].shape[0]
                    segment = lc.segment_rows(size, strip, -(-size // panel), per_sm * limits.sm_count * waves,
                                              warmup)
                    fn = lambda: run_line_cache(cell, tf, halo, strip, panel, segment, p, tdv=stream)  # noqa: E731
                    e = max_err(fn(), plain(op, p))
                    ms = timed(fn, 5)
                    dev_ms = device_ms(fn, 5)
                    copy_ms = timed(lambda: run_line_cache(cell, tf, halo, strip, panel, segment, p, 0), 5)
                    emit(dict(part="linecache", op=op, size=size, strip=strip, window=window, panel=panel, p=p,
                              waves=waves, segment=segment, ms=ms, device_ms=dev_ms, ms_per_iteration=ms / p,
                              device_ms_per_iteration=dev_ms / p, copy_ms=copy_ms, smem=smem,
                              ctas_per_sm=per_sm,
                              lane_cells_per_cell_step=line_cache_work(panel, hp, r, strip, segment, warmup),
                              max_abs_err=e))
    for part, kernel in (("sass", "tile_pass_kernel"), ("linecache-sass", "line_cache_kernel")):
        if part not in parts:
            continue
        cuobjdump = str(Path(cuda_lib.nvcc_path()).with_name("cuobjdump"))
        sass = subprocess.run([cuobjdump, "-sass", str(cuda_lib.build()[0])], capture_output=True,
                              text=True, check=True).stdout
        for op, functor in FUNCTORS.items():
            if op not in work:
                continue
            n_variant = cuda_lib.op_info(work[op][1].cuda_op)["n_variant"]
            # A run loop stores a whole run; the line cache's carry copies
            # (one word loaded and stored a trip) are not run loops.
            run = tp.RUN_ROWS if n_variant == 1 else 1
            loops = [lp for lp in run_loops(sass, functor, kernel) if lp["STS"] >= run * n_variant]
            emit(dict(part=part, op=op, run_loops=loops,
                      lds_per_cell_step=[lp["LDS"] * n_variant / lp["STS"] for lp in loops],
                      instructions_per_cell_step=[lp["instructions"] * n_variant / lp["STS"] for lp in loops]))
    return _write(args.out, lines)


def _write(path, lines) -> int:
    if path:
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
