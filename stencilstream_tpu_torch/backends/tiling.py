"""Tiling backend: temporal blocking over 2D tiles, any grid size.

Counterpart of ``stencilstream_tpu/backends/tiling.py`` in its clamped and
line-cache window modes. The host binds the call's cell to its functor
once (:class:`.cuda_lib.Binding`), then loops ``ceil(n / p)`` passes of ``p``
fused iterations and ping-pongs two global buffers; the last pass is partial
when ``p`` does not divide ``n``. One pass is one kernel launch:

* ``window_mode="clamped"`` (default): the grid is cut into
  ``tile_h x tile_w`` core tiles; each pass stages every tile with its
  compound halo (``r * p * k``, or the functor's declared reach summed over
  the pass: :func:`.tile_pass.pass_halo`) into one CTA's shared memory and
  runs ``p`` fused iterations there (:mod:`.tile_pass`).
* ``window_mode="linecache"``: each CTA walks a column panel's row segment
  strip by strip and carries the rows the next strip needs on chip, so rows
  are neither re-read nor recomputed within a walk (:mod:`.line_cache`).
  Grid edges are exact inside the kernel, so there is no band patch, and
  the TPU mode's eligibility rules (lane-aligned widths, 32-bit fields) do
  not apply: any grid runs whose strip holds ``2r`` rows, and a strip that
  does not raises ``ValueError``.

Where the TPU package cut full-width row strips to keep its lane dimension
contiguous, shared memory on Hopper favours square tiles, so there are no
transposed or width-split paths.
"""

from __future__ import annotations

import torch

from .. import tracing
from ..core.grid import Grid
from .base import StencilUpdateBase, resolve_halo
from .cuda_lib import (
    Binding, DeviceLimits, cell_field_bytes, device_limits, tile_cell_smem_bytes, tile_reach, tile_writes,
)
from .line_cache import bound_line_cache_pass, pick_linecache_config
from .tile_pass import RUN_ROWS, WARP, bound_tile_pass, pass_halo, tile_smem_bytes

__all__ = ["StencilUpdate", "pick_config", "TILE_LAW", "IN_PLACE_LAW", "REACH_LAW"]

#: The tile-pass geometry that ran fastest per iteration at 8192^2 on an
#: NVIDIA H100 80GB HBM3 at 700 W (``tile_sweep.py``; PERF.md), by the
#: shared-memory bytes of one cell (:func:`.cuda_lib.cell_smem_bytes`):
#: ``(tile_h, tile_w), halo r*p*k, CTAs per SM the window is sized for``.
#: HotSpot 12 B, Jacobi 8 B, Conway 2 B, the probe 40 B (five int32 fields);
#: 48 B was FDTD's coef cell at 1024^2 before its sub-steps ran in place
#: (16x128, p=4: 24.2 us of kernel an iteration, against 29.6 us at the
#: 40 B entry's 16x128, p=2, and half the passes for the host to launch).
#: Convection's cells at 3072x1024 (k=3, ten variant fields; k=2 thermal),
#: by profiler device time an iteration: the lean pseudo-transient cell,
#: 76 B in float32, 24x64 at p=2 (241.6 us, against 272.3 at the 48 B
#: entry's shrunk 16x64); its full cell, 84 B, runs one iteration a call,
#: so p=1: 8x128 (287.7 us); in float64 the lean cell, 152 B, 16x32 at p=2
#: (399.6 us), the full one, 168 B, 8x64 at p=1 (553.7 us), and the thermal
#: cell, 96 B, one iteration a call: 24x64 (196.7 us, against 247.8 at the
#: shrunk 8x128). The float32 thermal cell, 48 B, keeps FDTD's old entry.
#: Heights are whole 8-cell runs. The one-field cells' windows (core plus
#: twice the halo) are whole 32-lane warps wide, so the sub-steps' narrowing
#: windows waste fewer lanes than a core of whole warps would. Cells the tile
#: pass updates in place take :data:`IN_PLACE_LAW` instead.
TILE_LAW = {
    2: ((64, 240), 8, 2),
    8: ((96, 112), 8, 2),
    12: ((56, 112), 8, 2),
    40: ((32, 128), 4, 1),
    48: ((16, 128), 8, 1),
    76: ((24, 64), 6, 1),
    84: ((8, 128), 3, 1),
    96: ((24, 64), 2, 1),
    152: ((16, 32), 6, 1),
    168: ((8, 64), 3, 1),
}

#: The law of cells the tile pass updates in place (one shared plane per
#: variant field: :func:`.cuda_lib.tile_writes`), by the same bytes
#: (:func:`.cuda_lib.tile_cell_smem_bytes`), apart from :data:`TILE_LAW`, so
#: that no other cell's geometry moves. Since FDTD's functors declare their
#: reach (:data:`REACH_LAW`) only ``distributed`` and ``ring`` take its
#: entries for FDTD's cells (16, 32 B), with their stored halo r*p*k;
#: convection's straight pseudo-transient cells (44, 88 B) take theirs in
#: ``tiling`` too. FDTD at 2048^2 (``tile_sweep.py --ops
#: fdtd,fdtd_lut,fdtd_render --passes 4,5,6 --size 2048``; PERF.md),
#: profiler device time a pass of p=4 with the halo r*p*k = 8: the coef
#: cell, 32 B, 32x128 (209.3 us; 16x192 220.9, 32x96 239.4, 16x128 282.3,
#: the ping-pong 16x128 334.5; at p=5 and 6 no tile under 65.2 and 56.4 us
#: an iteration, against 52.3). The lut cell, 20 B, and the render cell,
#: 16 B, run two CTAs an SM at 32x96: lut 324.9 us (24x128 324.1, 32x128
#: 360.7, the ping-pong law's 28x32 675.9), render 314.5 (32x128 322.1,
#: 28x32 1424.4); at 1024^2 the fastest for both (lut 109.3 us, 140.3 at
#: 32x128, 177.7 at 28x32; render 110.7, 125.7, 365.0). p stays 4 or more:
#: a launch costs the host ~0.1-0.15 ms.
#: Convection at 3072x1024 (``tile_sweep.py --ops convection_pt_lean_f64,
#: convection_pt_f64,convection_pt_lean_f32,convection_pt_f32 --passes
#: 1,2,3``, 34 tiles; PERF.md), profiler device time an iteration, one CTA
#: an SM: the float64 cells, 88 B, 28x52 at p=2 (lean 205.5 us, full 226.2;
#: 24x52 222.8, 20x54 236.7, 16x64 239.0, 24x48 246.5, 32x32 292.1; the best
#: p=1, 20x90, 281.1, p=3, 20x46, 286.4, two CTAs, 8x52 at p=2, 279.0; the
#: ping-pong law's 16x32 in place 389.0, where ping-pong it read 401.7 in an
#: earlier run, PERF.md); the float32 cells, 44 B, 32x86 at p=2 (lean 126.6
#: us, full 149.4; 28x116 132.5, 40x84 141.2, 16x128, where the 32 B entry
#: would shrink to, 150.2; the best p=3, 32x78, 143.0). The full update runs
#: one iteration a call, so p=1 at the same tile (float64 389.1 us; the
#: ping-pong law's 8x64 read 584.0 before).
IN_PLACE_LAW = {
    16: ((32, 96), 8, 2),
    32: ((32, 128), 8, 1),
    44: ((32, 86), 6, 1),
    88: ((28, 52), 6, 1),
}

#: The law of in-place cells whose functor declares its sub-steps' reach
#: (:func:`.cuda_lib.tile_reach`), by the same bytes; its halo is the reach
#: summed over a pass (:func:`.tile_pass.pass_halo`: p for FDTD, whose
#: sub-steps read one-sided), so an entry's halo 8 is p=8. The ``tiling``
#: backend's alone: ``distributed`` and ``ring`` keep :data:`IN_PLACE_LAW`.
#: FDTD at 2048^2 (``tile_sweep.py --ops fdtd,fdtd_lut,fdtd_render --size
#: 2048 --passes 4,5,6,7,8``, 35 tiles, then the best again at p=4 and 8;
#: PERF.md), profiler device time an iteration: the coef cell, 32 B,
#: 40x112 at p=8, one CTA an SM (41.07, 40.96, 40.96 us; 56x80 41.83-42.09,
#: 32x128 42.37-42.47; 40x112 at p=4-7 49.7, 52.6, 49.2, 47.0; the best
#: two-CTA windows 24x104 and 24x88 at p=4, 44.4-44.7 and 46.1; against
#: 52.3 us at the symmetric law's 32x128, p=4). The lut cell, 20 B, 32x88 at
#: p=4, two CTAs (67.54, 66.86 us; 24x112 67.6-68.2; 32x192 at p=8 read
#: 63.06 once and 81.57 again), the render cell, 16 B, 56x80 at p=8, two
#: CTAs (65.49, 63.37 us; 40x112 65.1-65.8). p stays 4 or more.
REACH_LAW = {
    16: ((56, 80), 8, 2),
    20: ((32, 88), 4, 2),
    32: ((40, 112), 8, 1),
}


def law_entry(cell_bytes: int, in_place: bool = False, reach: bool = False):
    """The entry of :data:`TILE_LAW` (:data:`IN_PLACE_LAW` for a cell
    updated in place, :data:`REACH_LAW` for one whose functor also declares
    its sub-steps' reach) of the largest tabulated cell not larger than
    ``cell_bytes`` (the smallest one for a smaller cell)."""
    law = (REACH_LAW if reach else IN_PLACE_LAW) if in_place else TILE_LAW
    fits = [b for b in law if b <= cell_bytes]
    return law[max(fits) if fits else min(law)]


def pick_config(
    height: int,
    width: int,
    radius: int,
    n_subiterations: int,
    n_iterations: int,
    cell_bytes: int,
    limits: DeviceLimits,
    iters_per_pass: int | None = None,
    in_place: bool = False,
    reach: tuple[tuple[int, int], ...] | None = None,
) -> tuple[int, int, int]:
    """Choose ``(tile_h, tile_w, iters_per_pass)`` from the device's shared
    memory.

    The tile of :data:`TILE_LAW` (:data:`IN_PLACE_LAW` for a cell the tile
    pass updates in place, :data:`REACH_LAW` for one whose sub-steps'
    ``reach`` is given: :func:`.cuda_lib.tile_reach`) for ``cell_bytes`` (no
    larger than the grid, rounded up to whole runs and warps) and, unless
    given, the largest ``p`` whose halo (:func:`.tile_pass.pass_halo`: ``r*p*k``,
    or the reach summed over the pass) stays within the law's halo. While
    the window (:func:`.tile_pass.tile_smem_bytes`) exceeds the law's share
    of the shared memory a block may use, halve the core's height, then its
    width, as long as it stays at least twice the halo; then lower ``p``
    when it was not given; then halve the core down to one run by one warp.
    The core is never smaller than the halo.
    """
    (th, tw), halo, ctas = law_entry(cell_bytes, in_place, reach is not None)
    auto_p = iters_per_pass is None
    th = min(th, -(-height // RUN_ROWS) * RUN_ROWS)
    tw = min(tw, -(-width // WARP) * WARP)

    def pass_halo_of(p):
        return pass_halo(radius, p, n_subiterations, reach)

    p = max(1, halo // pass_halo_of(1)) if auto_p else iters_per_pass
    if n_iterations:
        p = min(p, n_iterations)

    def window_bytes(th, tw, p):
        return tile_smem_bytes(th, tw, pass_halo_of(p), cell_bytes)

    def narrower(tw):
        return max(WARP, tw // 2 // WARP * WARP)

    def shrink(th, tw, p):
        hp = pass_halo_of(p)
        if th // 2 >= max(RUN_ROWS, 2 * hp):
            return th // 2, tw, p
        if narrower(tw) < tw and narrower(tw) >= 2 * hp:
            return th, narrower(tw), p
        if auto_p and p > 1:
            return th, tw, p - 1
        if th > RUN_ROWS or tw > WARP:
            return max(RUN_ROWS, th // 2), narrower(tw), p
        return None

    while window_bytes(th, tw, p) > limits.smem_per_block // ctas and (smaller := shrink(th, tw, p)):
        th, tw, p = smaller
    if window_bytes(th, tw, p) > limits.smem_per_block:
        raise ValueError(
            f"a {th}x{tw} tile at iters_per_pass={p} needs {window_bytes(th, tw, p)} B of shared "
            f"memory; the device allows {limits.smem_per_block} B per block"
        )
    if pass_halo_of(p) > min(th, tw):
        raise ValueError(
            f"iters_per_pass={p} gives a halo of {pass_halo_of(p)} cells, more than the {th}x{tw} core tile"
        )
    return th, tw, p


class StencilUpdate(StencilUpdateBase):
    """Tiling (2D tile temporal-blocking) stencil updater.

    Extra keyword options:

    * ``iters_per_pass`` — temporal parallelism p, iterations fused per pass
      (auto: the halo of :data:`TILE_LAW`, or of
      :data:`.line_cache.LINE_LAW`; see :func:`pick_config` and
      :func:`.line_cache.pick_linecache_config`).
    * ``window_mode`` — ``"clamped"`` (2D tiles, the default) or
      ``"linecache"`` (streaming column panels).
    * ``strip_rows`` — rows a line-cache walk stages per step, for a cell
      with one variant field a whole number of 8-row runs (auto:
      :data:`.line_cache.LINE_LAW`'s, 32 for one-field cells); line-cache
      mode only.

    ``resolved_config`` holds the configuration the last call executed.
    """

    def __init__(
        self,
        params,
        *,
        iters_per_pass: int | None = None,
        window_mode: str = "clamped",
        strip_rows: int | None = None,
    ):
        super().__init__(params)
        if window_mode not in ("clamped", "linecache"):
            raise ValueError(f"window_mode must be 'clamped' or 'linecache' (got {window_mode!r})")
        if strip_rows is not None and window_mode != "linecache":
            raise ValueError("strip_rows applies to window_mode='linecache' only")
        self.iters_per_pass = iters_per_pass
        self.window_mode = window_mode
        self.strip_rows = strip_rows
        #: The configuration the last ``_update`` actually executed.
        self.resolved_config: dict | None = None

    @torch.no_grad()
    def _update(self, grid: Grid) -> Grid:
        p = self.params
        tf = p.transition_function
        n = int(p.n_iterations)
        offset = int(p.iteration_offset)
        with tracing.span("backends.plan") if tracing.on else tracing.OFF as span:
            halo_cell = resolve_halo(p.halo_value, grid)
            H, W = grid.shape
            limits = device_limits(grid.device)
            if self.window_mode == "linecache":
                cfg = pick_linecache_config(
                    H, W, tf.stencil_radius, tf.n_subiterations, n,
                    *cell_field_bytes(grid.arrays, tf), limits, self.iters_per_pass, self.strip_rows,
                )
                self.resolved_config = dict(window_mode="linecache", **cfg._asdict())
                ipp = cfg.iters_per_pass
                geometry = dict(
                    strip_rows=cfg.strip_rows, panel_cols=cfg.panel_cols, segment_rows=cfg.segment_rows
                )
                run_pass = bound_line_cache_pass
            else:
                th, tw, ipp = pick_config(
                    H, W, tf.stencil_radius, tf.n_subiterations, n,
                    tile_cell_smem_bytes(grid.arrays, tf), limits, self.iters_per_pass,
                    in_place=tile_writes(tf) is not None, reach=tile_reach(tf),
                )
                self.resolved_config = dict(
                    window_mode="clamped", tile_rows=th, tile_cols=tw, iters_per_pass=ipp
                )
                geometry = dict(tile=(th, tw))
                run_pass = bound_tile_pass
            if span is not None:
                span.attrs["geometry"] = self.resolved_config
            # One binding for every pass of the call; a call of no passes has none.
            call = Binding(grid.arrays, tf, halo_cell, offset, n) if n else None
        tdv = self._tdv_stream(grid)
        arrays = grid.arrays
        if call is None:
            return Grid(arrays)
        call.stream_tdv(tdv)
        # Pass i writes into pass i-2's result: two buffers, never the input.
        earlier = [None, None]
        for i_pass in range(-(-n // ipp)):
            arrays = run_pass(
                call, arrays, i_start=offset + i_pass * ipp, iters_per_pass=ipp, out=earlier[i_pass % 2], **geometry
            )
            earlier[i_pass % 2] = arrays
        return Grid(arrays)
