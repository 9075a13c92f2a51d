"""Tiling backend: temporal blocking over 2D tiles, any grid size.

Counterpart of ``stencilstream_tpu/backends/tiling.py`` in its clamped and
line-cache window modes. The host loops ``ceil(n / p)`` passes of ``p``
fused iterations and ping-pongs two global buffers; the last pass is partial
when ``p`` does not divide ``n``. One pass is one kernel launch:

* ``window_mode="clamped"`` (default): the grid is cut into
  ``tile_h x tile_w`` core tiles; each pass stages every tile with its
  compound halo ``r * p * k`` into one CTA's shared memory and runs ``p``
  fused iterations there (:mod:`.tile_pass`).
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

from ..core.grid import Grid
from .base import StencilUpdateBase, resolve_halo
from .cuda_lib import DeviceLimits, cell_field_bytes, cell_smem_bytes, device_limits
from .fused import halo_width
from .line_cache import line_cache_pass, pick_linecache_config
from .tile_pass import RUN_ROWS, WARP, tile_pass, tile_smem_bytes

__all__ = ["StencilUpdate", "pick_config", "TILE_LAW"]

#: The tile-pass geometry that ran fastest per iteration at 8192^2 on an
#: NVIDIA H100 80GB HBM3 at 700 W (``tile_sweep.py``; PERF.md), by the
#: shared-memory bytes of one cell (:func:`.cuda_lib.cell_smem_bytes`):
#: ``(tile_h, tile_w), halo r*p*k, CTAs per SM the window is sized for``.
#: HotSpot 12 B, Jacobi 8 B, Conway 2 B, the probe 40 B (five int32 fields),
#: FDTD's coef cell 48 B at 1024^2 (16x128, p=4: 36.6 us an iteration back
#: to back and 24.2 us of kernel, against 29.6 us of kernel at the 40 B
#: entry's 16x128, p=2, and half the passes for the host to launch).
#: Heights are whole 8-cell runs. The one-field cells' windows (core plus
#: twice the halo) are whole 32-lane warps wide, so the sub-steps' narrowing
#: windows waste fewer lanes than a core of whole warps would.
TILE_LAW = {
    2: ((64, 240), 8, 2),
    8: ((96, 112), 8, 2),
    12: ((56, 112), 8, 2),
    40: ((32, 128), 4, 1),
    48: ((16, 128), 8, 1),
}


def law_entry(cell_bytes: int):
    """The :data:`TILE_LAW` entry of the largest tabulated cell not larger
    than ``cell_bytes`` (the smallest one for a smaller cell)."""
    fits = [b for b in TILE_LAW if b <= cell_bytes]
    return TILE_LAW[max(fits) if fits else min(TILE_LAW)]


def pick_config(
    height: int,
    width: int,
    radius: int,
    n_subiterations: int,
    n_iterations: int,
    cell_bytes: int,
    limits: DeviceLimits,
    iters_per_pass: int | None = None,
) -> tuple[int, int, int]:
    """Choose ``(tile_h, tile_w, iters_per_pass)`` from the device's shared
    memory.

    The tile of :data:`TILE_LAW` for ``cell_bytes`` (no larger than the grid,
    rounded up to whole runs and warps) and, unless given, the largest ``p``
    whose halo ``r*p*k`` stays within the law's halo. While the window
    (:func:`.tile_pass.tile_smem_bytes`) exceeds the law's share of the
    shared memory a block may use, halve the core's height, then its width,
    as long as it stays at least twice the halo; then lower ``p`` when it
    was not given; then halve the core down to one run by one warp. The core
    is never smaller than the halo.
    """
    (th, tw), halo, ctas = law_entry(cell_bytes)
    auto_p = iters_per_pass is None
    th = min(th, -(-height // RUN_ROWS) * RUN_ROWS)
    tw = min(tw, -(-width // WARP) * WARP)
    p = max(1, halo // (radius * n_subiterations)) if auto_p else iters_per_pass
    if n_iterations:
        p = min(p, n_iterations)

    def window_bytes(th, tw, p):
        return tile_smem_bytes(th, tw, halo_width(radius, p, n_subiterations), cell_bytes)

    def narrower(tw):
        return max(WARP, tw // 2 // WARP * WARP)

    def shrink(th, tw, p):
        hp = halo_width(radius, p, n_subiterations)
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
    if halo_width(radius, p, n_subiterations) > min(th, tw):
        raise ValueError(
            f"iters_per_pass={p} gives a halo of {halo_width(radius, p, n_subiterations)} "
            f"cells, more than the {th}x{tw} core tile"
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
            run_pass = line_cache_pass
        else:
            th, tw, ipp = pick_config(
                H, W, tf.stencil_radius, tf.n_subiterations, n,
                cell_smem_bytes(grid.arrays, tf), limits, self.iters_per_pass,
            )
            self.resolved_config = dict(
                window_mode="clamped", tile_rows=th, tile_cols=tw, iters_per_pass=ipp
            )
            geometry = dict(tile=(th, tw))
            run_pass = tile_pass
        tdv = self._tdv_stream(grid)
        arrays = grid.arrays
        # Pass i writes into pass i-2's result: two buffers, never the input.
        earlier = [None, None]
        for i_pass in range(-(-n // ipp) if n else 0):
            arrays = run_pass(
                arrays, tf, halo_cell,
                i_start=offset + i_pass * ipp, offset=offset, n_iterations=n,
                iters_per_pass=ipp, out=earlier[i_pass % 2], tdv=tdv, **geometry,
            )
            earlier[i_pass % 2] = arrays
        return Grid(arrays)
