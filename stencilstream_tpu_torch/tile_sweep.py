"""Geometry of the tile-pass, line-cache and resident-grid kernels, timed on one NVIDIA card.

    python -m stencilstream_tpu_torch.tile_sweep [--out sweep.jsonl]
        [--parts grid,sass,linecache,linecache-sass,monotile] [--ops hotspot,jacobi5,conway,probe,fdtd]
        (also --ops convection_pt_f32,convection_pt_lean_f64,convection_thermal_f32,...) [--size 2048]
        [--passes 2,4,8] [--strips 16,32,64] [--windows 64,128] [--waves 1,2,3]
        [--qs 1,2,4,8] [--threads 1024,512]

Five parts, each printing one JSON line per measurement:

* ``grid``: one pass at each (tile, p) whose window fits one block's shared
  memory, for HotSpot (12 B a cell in shared memory), Jacobi5 (8 B), Conway
  (2 B) and the probe (40 B) at 8192^2, and FDTD's coef cell (32 B, updated
  in place) at 1024^2 on smaller tiles (:data:`FDTD_TILES`; also its lut and
  render cells, ``fdtd_lut`` and ``fdtd_render``; ``--size`` sets another
  side for all of these), and the convection functors
  (``convection_{pt,pt_lean,thermal}_{f32,f64}``, 48-168 B, k=3 and 2) at
  the JAX bench's 3072x1024 on :data:`CONVECTION_TILES`, with the CTAs per SM that
  the CUDA occupancy calculator reports, the time of a pass with no step
  active (staging and write-back alone, ``copy_ms``), and the cells the
  thread map computes per useful cell-step (:func:`thread_map_work`, or
  :func:`vector_map_work` for a functor that takes the vector map; the
  in-place map computes as many as the scalar one at its run length,
  :func:`in_place_map_work`).
  Compare ``ms_per_iteration``; ``device_ms`` is the kernel's own device
  time (``torch.profiler``), which a pass shorter than its host call
  (FDTD's) needs, since back-to-back calls then leave the card idle.
  Convection's straight pseudo-transient functors are ranked instead by
  ``update_device_ms``: the device time of one update as a convergence
  block runs it (:data:`CONVECTION_UPDATE`: 49 lean iterations in passes of
  p, the last one partial, or the full update's one iteration), so a p
  that leaves a long partial pass pays for it.
* ``sass``: the kernel library disassembled with ``cuobjdump -sass``: for
  each functor, the loops of the tile-pass kernel that load and store
  shared memory and hold no other such loop (the run loops of the interior
  and the edge sub-steps), with their instructions, shared loads (``LDS``)
  and stores (``STS``) in 4-byte words, and shuffles (``SHFL``), and the
  shared words loaded per cell-step (``LDS`` x fields a cell-step stores /
  ``STS``); and a digest of the whole instantiation's instructions
  (``sass_sha256``), which shows whether a change to the source moved it.
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
  probe at 600^2, FDTD's coef cell at 512^2, the convection functors at
  384x128 (:data:`MONO_SIZES`); one CTA
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
import hashlib
import itertools
import json
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import torch

from .backends import cuda_lib
from .core.cell import cell_leaves
from .backends import line_cache as lc
from .backends import monotile as mt
from .backends import tile_pass as tp
from .models import convection, conway, fdtd, hotspot, jacobi
from .tdv import tdv_stream
from .trace_cells import JACOBI5_COEFS, convection_experiment
from . import probe

__all__ = [
    "extended_blocks", "in_place_map_work", "main", "line_cache_work", "mono_work", "run_loops", "thread_map_work",
    "vector_map_work",
    "TILES", "PASSES",
]

#: Core tiles of the geometry sweep, heights a multiple of the run: widths a
#: multiple of the 32-lane warp, and widths whose window at a halo of 8
#: (p=8 at radius 1) is a multiple of it.
TILES = [(32, 64), (64, 64), (64, 96), (32, 128), (64, 128), (128, 64), (96, 96), (96, 128),
         (32, 192), (128, 128), (64, 256), (32, 256),
         (32, 112), (40, 112), (48, 112), (56, 112), (64, 112), (80, 112), (96, 112),
         (32, 240), (48, 240), (64, 240)]
#: Core tiles of FDTD's geometry sweep: its 32 B cells (in place) leave room
#: for windows of ~7.2k cells, the lut cell's 20 B and the render cell's 16 B
#: for more; runs of 4 rows, so heights need not be 8-row runs. With the
#: halo of its one-sided reach (p, not 2p), windows of one CTA an SM up to
#: 56x80 or 40x112 at p=8, and of two (~113 KB) such as 24x88 or 16x120.
FDTD_TILES = [(8, 64), (8, 128), (16, 64), (16, 96), (16, 128), (16, 192), (24, 64), (24, 96),
              (24, 128), (32, 64), (32, 96), (32, 128), (48, 64), (64, 64), (40, 128), (48, 128),
              (24, 192), (32, 192), (16, 256), (64, 96), (96, 64),
              (16, 120), (24, 88), (24, 104), (32, 88), (32, 112), (40, 96), (40, 112), (48, 80), (48, 96),
              (56, 80), (56, 96), (64, 80), (24, 112), (16, 112)]
#: Core tiles of the convection functors' geometry sweep: their 48-168 B
#: cells (k=3 for the pseudo-transient ones) leave room for windows of 1.4k
#: to 4.8k cells; one cell a thread for ten variant fields. Then tiles near
#: the largest windows of the cells updated in place (88 B in float64, 44 B
#: in float32) at p = 1-3, one CTA an SM or two, whose narrowing windows
#: fill their 32-lane chunks best (``in_place_map_work``); and those of the
#: halo 2p of their declared reach at p = 2-4 (windows 40-54 rows by 48-80
#: columns in float64, up to 54 by 96-128 in float32).
CONVECTION_TILES = [(8, 32), (8, 64), (8, 96), (8, 128), (16, 32), (16, 64), (16, 96), (16, 128), (24, 32),
                    (24, 64), (32, 32), (32, 64), (48, 32),
                    (24, 48), (24, 52), (28, 52), (20, 54), (8, 52), (20, 46), (16, 46), (32, 58), (24, 60),
                    (20, 90), (12, 58), (8, 60), (40, 84), (32, 86), (28, 116), (48, 54), (32, 78), (64, 46),
                    (40, 92), (56, 60), (48, 90),
                    (29, 52), (32, 56), (24, 72), (44, 40), (12, 56), (18, 40), (20, 68), (42, 36), (14, 36),
                    (25, 48), (38, 32), (20, 48), (36, 88), (46, 88), (28, 80), (38, 80), (44, 52), (60, 52),
                    (60, 56), (60, 48), (28, 82), (24, 108)]
#: Iterations of one update of convection's straight pseudo-transient
#: functors, by functor: upstream's convergence block of nerr = 50 runs 49
#: lean iterations, then one full one (``models/convection.py``:
#: ``Simulation``), each a call of its own.
CONVECTION_UPDATE = {f"convection_{kind}_{width}": n for kind, n in (("pt_lean", 49), ("pt", 1))
                     for width in ("f32", "f64")}
#: The convection functors' grid: the JAX bench's 3072x1024 (res 1024).
CONVECTION_SHAPE = (3072, 1024)
#: Iterations per pass of the geometry sweep.
PASSES = [2, 4, 6, 8, 12, 16]
SIZE = 8192
#: Warps of a tile-pass CTA (``csrc/tile_pass.cu``: ``kTileWarps``).
KERNEL_WARPS = 16
#: Grid side of the grid and line-cache sweeps where it is not SIZE (unless
#: ``--size`` sets one): FDTD's upstream mono-benchmark runs 1024^2.
SIZES = {"fdtd": 1024}
#: Strip heights and window widths (panel + both halos) of the line-cache
#: sweep: whole runs, and whole warps.
STRIPS = [16, 32, 64]
WINDOWS = [64, 96, 128, 160, 192, 256]
#: Grid side, or shape, of each resident-grid case (the probe's 40 B a cell
#: fit at 600^2; convection at res 128).
MONO_SIZES = {"hotspot": 1024, "jacobi5": 1024, "probe": 600, "fdtd": 512, "convection": (384, 128)}
#: Device functor of each swept case, as ptxas names its instantiation.
FUNCTORS = {"hotspot": "HotspotOp", "jacobi5": "Jacobi5GeneralOp", "conway": "ConwayOp", "probe": "ProbeOp",
            "fdtd": "FdtdCoefOp", "fdtd_lut": "FdtdLutOp", "fdtd_render": "FdtdRenderOp",
            **{f"convection_{kind}_{width}": f"Convection{name}{width.upper()}Op"
               for kind, name in (("pt", "Pt"), ("pt_lean", "PtLean"), ("thermal", "Thermal"))
               for width in ("f32", "f64")}}


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


def convection_sweep_case(device, op, shape=CONVECTION_SHAPE):
    """A convection functor's cell on ``shape``: random fields (a flow in
    progress), the JAX bench experiment's parameters at that size, the
    active region the grid less its last row and column."""
    rng = np.random.default_rng(6)
    dtype = np.float64 if op.endswith("f64") else np.float32
    e = convection_experiment(shape[1])
    assert (e.nx + 1, e.ny + 1) == tuple(shape), shape
    cell = convection.ThermalConvectionCell(**{
        f: torch.tensor(rng.standard_normal(shape).astype(dtype), device=device) for f in convection.FIELDS})
    if "thermal" in op:
        tf = convection.make_thermal_kernel(e, dtype, dt=e.dt_diff)
    elif "folded" in op:
        tf = convection.make_folded_pseudo_transient_kernel(e, dtype, with_err="lean" not in op)
        cell = folded_cell(cell, convection.folded_planes(e, shape, dtype), device)
    else:
        tf = convection.make_pseudo_transient_kernel(e, dtype, with_err="lean" not in op)
    assert tf.cuda_op == op, (tf.cuda_op, op)
    return cell, tf, convection.folded_zero_cell() if "folded" in op else convection.zero_cell()


def folded_cell(cell, planes: dict, device) -> "convection.FoldedConvectionCell":
    """A straight convection cell with the folded cell's ``planes`` (numpy
    arrays, :func:`.models.convection.folded_planes`) beside its fields."""
    return convection.FoldedConvectionCell(
        **{f: getattr(cell, f) for f in convection.FIELDS},
        **{k: torch.tensor(v, device=device) for k, v in planes.items()},
    )


def convection_case(op, shape, rng, device, active=None):
    """(cell, transition function, halo cell) of convection functor ``op``
    for holding a kernel against its plain version: random fields and
    random parameters that are not powers of two (the viscosity's
    temperature coefficient of order 0.1), the active region ``active =
    (nx, ny)`` (default: the grid less its last row and column) and a halo
    of 0.5 in every field; a folded functor's cell carries the planes of
    that region at random coefficients (the bool planes' halo: True)."""
    dtype = np.float64 if op.endswith("f64") else np.float32
    nx, ny = active or (shape[0] - 1, shape[1] - 1)
    fields = {f: torch.tensor(rng.standard_normal(shape).astype(dtype), device=device) for f in convection.FIELDS}
    u = lambda lo, hi: dtype(rng.uniform(lo, hi))  # noqa: E731
    if "thermal" in op:
        tf = convection.ThermalSolverKernel(nx=nx, ny=ny, dx=u(.05, .2), dy=u(.05, .2), dt=u(1e-3, 1e-2),
                                            DcT=u(.3, 1.5))
    elif "folded" in op:
        tf = convection.FoldedPseudoTransientKernel(
            eta0=u(.5, 2), deltaT=u(.5, 2), delta_eta_delta_T=u(.05, .2), roh0_g_alpha=u(30, 300),
            dx=u(.05, .2), dy=u(.05, .2), rho=u(.5, 2), with_err="lean" not in op,
        )
        region = types.SimpleNamespace(nx=nx, ny=ny, delta_tau_iter=u(.01, .1), beta=u(.5, 2), dampX=u(.8, 1),
                                       dampY=u(.8, 1))
        halo = convection.FoldedConvectionCell(**{f: 0.5 for f in convection.FIELDS + convection.PLANES})
        cell = folded_cell(convection.ThermalConvectionCell(**fields), convection.folded_planes(region, shape, dtype),
                           device)
        assert tf.cuda_op == op, (tf.cuda_op, op)
        return cell, tf, halo
    else:
        tf = convection.PseudoTransientKernel(
            nx=nx, ny=ny, roh0_g_alpha=u(30, 300), delta_eta_delta_T=u(.05, .2), eta0=u(.5, 2),
            deltaT=u(.5, 2), dx=u(.05, .2), dy=u(.05, .2), delta_tau_iter=u(.01, .1), beta=u(.5, 2),
            rho=u(.5, 2), dampX=u(.8, 1), dampY=u(.8, 1), with_err="lean" not in op,
        )
    assert tf.cuda_op == op, (tf.cuda_op, op)
    halo = convection.ThermalConvectionCell(**{f: 0.5 for f in convection.FIELDS})
    return convection.ThermalConvectionCell(**fields), tf, halo


def extended_blocks(core: tuple[int, int], halo: int, extra: tuple[int, int] = (1, 3)) -> list[tuple]:
    """Blocks on which to hold the tile pass's extended mode against its
    plain version (``chip_smoke.py``, ``tests/test_torch_kernels.py``),
    ``(label, block shape, origin, grid range, stored halo)``: the nine
    shards of a 3x3 mesh of ``core``-sized cores over a grid that ends
    inside its last row and column of shards (the interior shard, edge and
    corner shards, negative origins, padding), each storing ``extra`` more
    rows and columns of halo than the pass's ``halo``; and a ring chunk (a
    stored halo of rows only, the grid's full width)."""
    c0, c1 = core
    sh, sw = halo + extra[0], halo + extra[1]
    H, W = 3 * c0 - 5, 3 * c1 - 7
    blocks = [(f"shard ({iy}, {ix})", (c0 + 2 * sh, c1 + 2 * sw), (iy * c0 - sh, ix * c1 - sw), (H, W), (sh, sw))
              for iy in range(3) for ix in range(3)]
    blocks.append(("ring chunk", (c0 + 2 * halo, W), (c0 - halo, 0), (H, W), (halo, 0)))
    return blocks


def cases(device, size=None, ops=("hotspot", "jacobi5", "conway", "probe")):
    """name -> (cell, transition function, halo cell) at size^2 for each of
    ``ops`` (by default :data:`SIZE`, FDTD's :data:`SIZES`)."""
    rng = np.random.default_rng(5)
    shape = (size or SIZE, size or SIZE)
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
    } if any(not op.startswith(("fdtd", "convection")) for op in ops) else {}
    for op in ops:
        if op.startswith("convection"):
            work[op] = convection_sweep_case(device, op)
        if op.startswith("fdtd"):
            work[op] = fdtd_case(device, size or SIZES["fdtd"], "coef" if op == "fdtd" else op[len("fdtd_"):])
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


def vector_map_work(tile, halo: int, radius: int, run: int = tp.QUAD_RUN, sh: int = 0) -> dict:
    """A model of the tile pass's vector thread map (``csrc/tile_pass.cu``:
    ``substep_quads`` and the choice in ``run_steps``) over the interior
    sub-steps of one tile whose planes are shifted by ``sh`` elements
    (window column c is 16-byte aligned where ``(sh + c) % 4 == 0``).

    Sub-step s computes the window narrowed by m = s + 1 per side: in groups
    of 4 aligned columns, 32 a warp, and whole runs of ``run`` rows; or, where an
    overhanging group would land on a cell that a later sub-step reads, in
    the scalar map's 32-column chunks (``scalar_steps``). Returns the
    lane-cells per useful cell-step (core cells x sub-steps), the extreme
    offsets read (``read``) and written (``written``) from a plane's first
    element (the plane is ``plane`` elements), the narrowed windows' cells
    that no lane computed (``uncovered``) and the writes that land on
    another cell of a narrowed window (``clobbered``)."""
    if radius != 1:
        raise ValueError("the vector map takes functors of radius 1")
    th, tw = tile
    wh, ww = th + 2 * halo, tw + 2 * halo
    pitch = -(-ww // tp.PITCH_ALIGN) * tp.PITCH_ALIGN
    lanes = np.arange(tp.WARP)
    lane_cells, uncovered, clobbered, scalar_steps = 0, 0, 0, 0
    reads, writes = [], []
    for m in range(1, halo + 1):
        gl = ((sh + m) & ~3) - sh
        ge = ((sh + ww - m + 3) & ~3) - sh
        if gl + m >= ww - pitch and ge <= pitch + m:
            n_groups = (ge - gl) // 4
            last = min(n_groups, tp.WARP) - 1
            starts = [max(0, min(32 * j, n_groups - 32)) for j in range(-(-n_groups // tp.WARP))]
            cols = [gl + 4 * (g0 + np.minimum(lanes, last)) for g0 in starts]
            outer = [np.where(lanes == 0, np.maximum(c - 1, -sh), c[last] + 4) for c in cols]
            cols = [(c[:, None] + np.arange(4)).ravel() for c in cols]
            rows_run, chunk = run, 4 * tp.WARP
        else:
            scalar_steps += 1
            cols = [min(m + 32 * j, ww - m - 32) + lanes for j in range(-(-(ww - 2 * m) // tp.WARP))]
            outer = [np.concatenate([c - 1, c + 1]) for c in cols]
            rows_run, chunk = tp.RUN_ROWS, tp.WARP
        n_runs = -(-(wh - 2 * m) // rows_run)
        lane_cells += n_runs * rows_run * len(cols) * chunk
        computed = np.zeros((wh, ww), bool)
        for jy in range(n_runs):
            r = min(m + jy * rows_run, wh - m - rows_run)
            rows = np.arange(r, r + rows_run)[:, None]
            for c, o in zip(cols, outer):
                written = rows * pitch + sh + c
                writes.append(written)
                reads += [(rows + dr) * pitch + sh + c for dr in (-1, 0, 1)]
                reads.append(np.arange(r - 1, r + rows_run + 1)[:, None] * pitch + sh + o)
                inside = (c >= 0) & (c < ww)
                computed[r : r + rows_run, c[inside]] = True
                row2, col2 = np.divmod(written[:, ~inside] - sh, pitch)
                clobbered += int(((row2 >= m) & (row2 < wh - m) & (col2 >= m) & (col2 < ww - m)).sum())
        uncovered += int((~computed[m : wh - m, m : ww - m]).sum())
    reads, writes = np.concatenate([x.ravel() for x in reads]), np.concatenate([x.ravel() for x in writes])
    return dict(lane_cells_per_cell_step=lane_cells / (th * tw * halo), read=(int(reads.min()), int(reads.max())),
                written=(int(writes.min()), int(writes.max())), plane=wh * pitch + tp.PITCH_ALIGN,
                uncovered=uncovered, clobbered=clobbered, scalar_steps=scalar_steps)


def in_place_map_work(tile, halo: int, radius: int, run: int = tp.IN_PLACE_RUN, in_place: bool = True,
                      reach=None) -> dict:
    """A model of the tile pass's scalar thread map (``csrc/tile_pass.cu``:
    ``substep``, ``substep_in_place``) over the sub-steps of one tile:
    sub-step s computes the window narrowed as the kernel narrows it
    (:func:`.backends.tile_pass.pass_narrowing`: r*(s+1) per side, or, given
    the ``reach`` ``(lo, hi)`` of each sub-step of an iteration, the low and
    the high reaches of sub-steps 0..s), over the iterations the halo
    holds; each warp takes (32-column chunk, run of ``run`` rows) pairs dealt
    round-robin. In place, the last chunk and the last run keep their places
    and the lanes and rows past the window skip; otherwise
    (``in_place=False``, the ping-pong map, one-cell runs for multi-field
    cells) they are shifted back inside the window. Returns the lane-cells
    per useful cell-step (core cells x sub-steps) and, over all sub-steps,
    the narrowed windows' cells no lane stores (``uncovered``) or more than
    one lane stores (``stored_twice``: in place, a second lane would read a
    cell another has updated), and the stores outside them (``outside``)."""
    th, tw = tile
    wh, ww = th + 2 * halo, tw + 2 * halo
    lanes = np.arange(tp.WARP)
    lane_cells = uncovered = twice = outside = 0
    k = len(reach) if reach else 1
    narrowing = tp.pass_narrowing(radius, halo // tp.pass_halo(radius, 1, k, reach), k, reach)
    for lo, hi in narrowing:
        n_runs, n_chunks = -(-(wh - lo - hi) // run), -(-(ww - lo - hi) // tp.WARP)
        stores = np.zeros((wh, ww), int)
        for warp in range(KERNEL_WARPS):
            jx, jy = warp % n_chunks, warp // n_chunks
            while jy < n_runs:
                r = lo + run * jy if in_place else min(lo + run * jy, wh - hi - run)
                rows = np.arange(r, min(r + run, wh - hi) if in_place else r + run)
                c = (lo + 32 * jx if in_place else min(lo + 32 * jx, ww - hi - 32)) + lanes
                if in_place:
                    c = c[c < ww - hi]
                for row in rows:
                    np.add.at(stores[row], c, 1)
                lane_cells += tp.WARP * run
                jx += KERNEL_WARPS
                jy, jx = jy + jx // n_chunks, jx % n_chunks
        inner = stores[lo : wh - hi, lo : ww - hi]
        uncovered += int((inner == 0).sum())
        twice += int((inner > 1).sum())
        outside += int(stores.sum() - inner.sum())
    return dict(lane_cells_per_cell_step=lane_cells / (th * tw * len(narrowing)), uncovered=uncovered,
                stored_twice=twice, outside=outside)


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
#: 4-byte words a shared-memory access moves, by its width suffix (any other: 1).
_WIDTH_WORDS = {"128": 4, "64": 2}


def _shared_words(body: list[str], mnemonic: str) -> int:
    """The 4-byte words that the ``mnemonic`` (``LDS`` or ``STS``)
    instructions of a loop's ``body`` move."""
    words = 0
    for op in body:
        access = re.search(rf"\b{mnemonic}\b((?:\.\w+)*)", op)
        if access:
            words += max((_WIDTH_WORDS.get(s, 1) for s in access.group(1).split(".")[1:]), default=1)
    return words


def kernel_code(sass: str, functor: str, kernel: str = "tile_pass_kernel") -> list[tuple[int, str]]:
    """``(address, instruction)`` of ``functor``'s own instantiation of
    ``kernel`` in a ``cuobjdump -sass`` listing."""
    name = f"_ZN2ss{len(kernel)}{kernel}INS_{len(functor)}{functor}E"
    chunk = next((c for c in sass.split("Function : ")[1:] if c.startswith(name)), "")
    return [(int(a, 16), op) for a, op in _SASS_INSTRUCTION.findall(chunk)]


def run_loops(sass: str, functor: str, kernel: str = "tile_pass_kernel") -> list[dict]:
    """The run loops of ``functor``'s ``kernel`` in a ``cuobjdump -sass``
    listing: loops (spans closed by a backward branch) that load and store
    shared memory, copy nothing from global memory (``LDGSTS``) and hold no
    other such loop; over the loop's body, its ``instructions``, the 4-byte
    words its shared loads (``LDS``) and stores (``STS``) move (a ``.128``
    access counts 4, a ``.64`` 2, any other 1) and its shuffles (``SHFL``)."""
    code = kernel_code(sass, functor, kernel)
    loops = []
    for addr, op in code:
        branch = _BACKWARD_BRANCH.search(op)
        if branch and int(branch.group(1), 16) < addr:
            body = [o for a, o in code if int(branch.group(1), 16) <= a <= addr]
            count = lambda pattern: sum(1 for o in body if re.search(pattern, o))  # noqa: E731
            loops.append(dict(span=(int(branch.group(1), 16), addr), instructions=len(body),
                              LDS=_shared_words(body, "LDS"), STS=_shared_words(body, "STS"),
                              SHFL=count(r"\bSHFL"), LDGSTS=count(r"\bLDGSTS")))
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
    """Mean device time, in ms, of the package's kernels that one call of
    ``fn()`` launches, by ``torch.profiler`` over ``reps`` calls after a
    warm-up. Unlike :func:`timed` it leaves out the card's idle time
    between calls, which a kernel shorter than its host call leaves. The
    profiler can miss a launch (one of five in some windows), so the time
    is the mean of the launches it saw, times the launches a call makes. A
    window in which it saw none (it missed some early in a process) is
    profiled again, up to ``attempts`` times; 0 if it never sees one."""
    from .trace_cells import profiled

    def calls():
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        _, kernels, _ = profiled(calls)
        count = sum(k["count"] for k in kernels.values())
        if count:
            return sum(k["ms"] for k in kernels.values()) / count * max(1, round(count / reps))
    return 0.0


def run_pass(cell, tf, halo, tile, p, n=None, tdv=None):
    """One pass of p iterations; with ``n=0`` no step is active, so the
    kernel only stages and writes back. ``tdv``: the call's TDV stream."""
    return tp.tile_pass(cell, tf, halo, i_start=0, offset=0, n_iterations=p if n is None else n,
                        iters_per_pass=p, tile=tile, tdv=tdv)


def run_update(cell, tf, halo, tile, p, n, tdv=None):
    """One call of ``n`` iterations in passes of p at ``tile``, the last
    pass partial where p does not divide n, as ``tiling`` runs it."""
    for i_start in range(0, n, p):
        cell = tp.tile_pass(cell, tf, halo, i_start=i_start, offset=0, n_iterations=n, iters_per_pass=p,
                            tile=tile, tdv=tdv)
    return cell


def run_line_cache(cell, tf, halo, strip, panel, segment, p, n=None, tdv=None):
    """One line-cache pass of p iterations; with ``n=0`` no step is active,
    so the kernel only stages and stores. ``tdv``: the call's TDV stream."""
    return lc.line_cache_pass(cell, tf, halo, i_start=0, offset=0, n_iterations=p if n is None else n,
                              iters_per_pass=p, strip_rows=strip, panel_cols=panel, segment_rows=segment,
                              tdv=tdv)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="tile_sweep", description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the JSON lines to this file")
    parser.add_argument("--passes", default=",".join(map(str, PASSES)),
                        help="p values of the geometry sweep (convection's straight pseudo-transient functors: rank "
                             "by update_device_ms, a 49-iteration lean update or the full update's one iteration)")
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
    parser.add_argument("--size", type=int, help=f"grid side of the grid and line-cache sweeps (default {SIZE}, "
                                                  f"FDTD's {SIZES['fdtd']})")
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
        for op in args.ops.split(","):
            if op.startswith("convection"):
                cell, tf, halo = convection_sweep_case(device, op, MONO_SIZES["convection"])
            elif op in MONO_SIZES:
                cell, tf, halo = cases(device, MONO_SIZES[op], ops=(op,))[op]
            else:
                continue
            H, W = cell_leaves(cell)[0].shape
            r, k, n = tf.stencil_radius, tf.n_subiterations, args.mono_n
            cell_bytes = cuda_lib.cell_smem_bytes(cell, tf)
            stream = tdv_stream(tf, 0, n, device)
            want = mt.monotile_plain(cell, tf, halo, offset=0, n_iterations=n, tdv=stream)
            run = tp.RUN_ROWS if cuda_lib.op_info(tf.cuda_op)["n_variant"] == 1 else 1
            for threads in map(int, args.threads.split(",")):
                per_sm = mt.MAX_THREADS // threads
                band = max(r, -(-H // (limits.sm_count * per_sm)))
                for q in map(int, args.qs.split(",")):
                    smem = mt.monotile_smem_bytes(band, q, W, r, cell_bytes)
                    if q * r > band or smem > mt.smem_budget(limits, per_sm):
                        continue
                    plan = mt.MonotilePlan(band, -(-H // band), mt.monotile_smem_bytes(band, 1, W, r, cell_bytes),
                                           q, threads)
                    fn = lambda: mt.monotile(cell, tf, halo, offset=0, n_iterations=n, plan=plan, tdv=stream)  # noqa: E731
                    e = max_err(fn(), want)
                    ms = timed(fn, 5)
                    emit(dict(part="monotile", op=op, size=[H, W], cell_bytes=cell_bytes, threads=threads, q=q,
                              band=band, n_ctas=plan.n_ctas, n=n, ms=ms, us_per_substep=ms * 1e3 / (n * k),
                              smem=smem, ctas_per_sm=mt.monotile_residency(tf, plan, W, device),
                              lane_cells_per_cell_step=mono_work(band, q, r, run), max_abs_err=e))
            del cell, want
        if parts == {"monotile"}:
            return _write(args.out, lines)
    work = cases(device, args.size, ops=tuple(args.ops.split(",")))
    plain_cache = {}

    def plain(op, p):
        if (op, p) not in plain_cache:
            for key in [k for k in plain_cache if k[0] != op]:
                del plain_cache[key]
            cell, tf, halo = work[op]
            plain_cache[(op, p)] = tp.tile_pass_plain(cell, tf, halo, i_start=0, offset=0,
                                                      n_iterations=p, iters_per_pass=p)
        return plain_cache[(op, p)]

    if "grid" in parts:
        emit(dict(part="build", ptxas=kernel_report(cuda_lib.build()[2], "tile_pass_kernel")))
        for op in args.ops.split(","):
            cell, tf, halo = work[op]
            cell_bytes = cuda_lib.tile_cell_smem_bytes(cell, tf)
            info = cuda_lib.op_info(tf.cuda_op)
            variant_bytes = info["n_variant"] * info["dtype"].itemsize
            run = (tp.RUN_ROWS if info["n_variant"] == 1 else tp.in_place_run_rows(variant_bytes) if info["writes"]
                   else 1)
            for p in map(int, args.passes.split(",")):
                stream = tdv_stream(tf, 0, p, device)
                tiles = FDTD_TILES if op.startswith("fdtd") else CONVECTION_TILES if op.startswith("convection") else TILES
                n_update = CONVECTION_UPDATE.get(op, 0)
                update_stream = tdv_stream(tf, 0, n_update, device) if n_update else None
                for tile in tiles:
                    hp = tp.pass_halo(tf.stencil_radius, p, tf.n_subiterations, info["reach"])
                    smem = tp.tile_smem_bytes(*tile, hp, cell_bytes)
                    if smem > limits.smem_per_block or hp > min(tile):
                        continue
                    fn = lambda: run_pass(cell, tf, halo, tile, p, tdv=stream)  # noqa: E731
                    e = max_err(fn(), plain(op, p))
                    ms = timed(fn, 5)
                    dev_ms = device_ms(fn, 5)
                    copy_ms = timed(lambda: run_pass(cell, tf, halo, tile, p, 0), 5)
                    lanes, window = thread_map_work(tile, hp, tf.stencil_radius, run)
                    if info["vector_map"]:
                        lanes = vector_map_work(tile, hp, tf.stencil_radius)["lane_cells_per_cell_step"]
                    elif info["writes"]:
                        lanes = in_place_map_work(tile, hp, tf.stencil_radius, run,
                                                  reach=info["reach"])["lane_cells_per_cell_step"]
                    update = {}
                    if p <= n_update:
                        fn = lambda: run_update(cell, tf, halo, tile, p, n_update, update_stream)  # noqa: E731
                        update = dict(update_iterations=n_update, update_device_ms=device_ms(fn, 3),
                                      update_max_abs_err=max_err(fn(), plain(op, n_update)))
                    emit(dict(part="grid", op=op, size=list(cell_leaves(cell)[0].shape), cell_bytes=cell_bytes,
                              tile=list(tile), p=p, halo=hp, ms=ms, device_ms=dev_ms, ms_per_iteration=ms / p,
                              device_ms_per_iteration=dev_ms / p, copy_ms=copy_ms, smem=smem,
                              ctas_per_sm=tp.tile_pass_residency(tf, tile, p, device),
                              lane_cells_per_cell_step=lanes, window_cells_per_cell_step=window,
                              max_abs_err=e, **update))
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
                    if strip % lc.run_rows(cell, tf):
                        continue
                    per_sm = lc.line_cache_residency(tf, strip, panel, p, device)
                    warmup = lc.warmup_rows(r, steps, strip)
                    H, W = cell_leaves(cell)[0].shape
                    segment = lc.segment_rows(H, strip, -(-W // panel), per_sm * limits.sm_count * waves, warmup)
                    fn = lambda: run_line_cache(cell, tf, halo, strip, panel, segment, p, tdv=stream)  # noqa: E731
                    e = max_err(fn(), plain(op, p))
                    ms = timed(fn, 5)
                    dev_ms = device_ms(fn, 5)
                    copy_ms = timed(lambda: run_line_cache(cell, tf, halo, strip, panel, segment, p, 0), 5)
                    emit(dict(part="linecache", op=op, size=[H, W], strip=strip, window=window, panel=panel, p=p,
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
            info = cuda_lib.op_info(work[op][1].cuda_op)
            # Fields a cell-step stores: every variant one, or in the tile
            # pass those its sub-step writes in place (sub-step 0's: as many
            # in each for FDTD, not for convection, whose loops' own LDS and
            # STS words are in run_loops).
            stored = info["n_variant"]
            if info["writes"] and kernel == "tile_pass_kernel":
                stored = bin(info["writes"][0]).count("1")
            # A run loop stores a whole run (in place, a run of masked rows:
            # each row's stores); the line cache's carry copies (one word
            # loaded and stored a trip) are not run loops.
            run = tp.RUN_ROWS if info["n_variant"] == 1 else 1
            loops = [lp for lp in run_loops(sass, functor, kernel) if lp["STS"] >= run * stored]
            code = "\n".join(ins for _, ins in kernel_code(sass, functor, kernel))
            emit(dict(part=part, op=op, run_loops=loops,
                      lds_per_cell_step=[lp["LDS"] * stored / lp["STS"] for lp in loops],
                      shfl_per_cell_step=[lp["SHFL"] * stored / lp["STS"] for lp in loops],
                      instructions_per_cell_step=[lp["instructions"] * stored / lp["STS"] for lp in loops],
                      sass_sha256=hashlib.sha256(code.encode()).hexdigest()))
    return _write(args.out, lines)


def _write(path, lines) -> int:
    if path:
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
