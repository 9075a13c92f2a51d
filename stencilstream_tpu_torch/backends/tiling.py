"""Tiling backend: temporal blocking over 2D tiles, any grid size.

Counterpart of ``stencilstream_tpu/backends/tiling.py`` in its clamped
mode. The grid is cut into ``tile_h x tile_w`` core tiles; each pass stages
every tile with its compound halo ``r * p * k`` into one CTA's shared memory
and runs ``p`` fused iterations there (:mod:`.tile_pass`). The host loops
``ceil(n / p)`` passes and ping-pongs two global buffers; the last pass is
partial when ``p`` does not divide ``n``.

Where the TPU package cut full-width row strips to keep its lane dimension
contiguous, shared memory on Hopper favours square tiles, so there are no
transposed or width-split paths.
"""

from __future__ import annotations

import torch

from ..core.grid import Grid
from .base import StencilUpdateBase, resolve_halo
from .cuda_lib import DeviceLimits, cell_smem_bytes, device_limits
from .fused import halo_width
from .tile_pass import tile_pass

__all__ = ["StencilUpdate", "pick_config", "DEFAULT_TILE"]

#: Core tile side: a multiple of the 32-thread warp, so staging loads are
#: whole rows of coalesced 128-byte lines.
DEFAULT_TILE = 64


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

    A 64x64 core (smaller for a smaller grid) and, unless given, the
    largest ``p`` whose halo ``r*p*k`` stays within an eighth of the core,
    so the average window is some 1.2x the core; then ``p`` (and, at
    ``p = 1`` or a given ``p``, the tile) shrinks until the window of
    ``cell_bytes`` per cell fits half the shared memory a block may use, so
    two CTAs share an SM. The core is never smaller than the halo.
    """
    auto_p = iters_per_pass is None
    th = min(DEFAULT_TILE, -(-height // 8) * 8)
    tw = min(DEFAULT_TILE, -(-width // 32) * 32)
    p = max(1, min(th, tw) // (8 * radius * n_subiterations)) if auto_p else iters_per_pass
    if n_iterations:
        p = min(p, n_iterations)

    def window_bytes(th, tw, p):
        hp = halo_width(radius, p, n_subiterations)
        return (th + 2 * hp) * (tw + 2 * hp) * cell_bytes

    while window_bytes(th, tw, p) > limits.smem_per_block // 2:
        if auto_p and p > 1:
            p -= 1
        elif th > 8 or tw > 32:
            th, tw = max(8, th // 2), max(32, tw // 2)
        else:
            break
    if window_bytes(th, tw, p) > limits.smem_per_block:
        raise ValueError(
            f"a {th}x{tw} tile at iters_per_pass={p} needs {window_bytes(th, tw, p)} B of "
            f"shared memory; the device allows {limits.smem_per_block} B per block"
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
      (auto: halo at most an eighth of the core; see :func:`pick_config`).

    ``resolved_config`` holds the configuration the last call executed.
    """

    def __init__(self, params, *, iters_per_pass: int | None = None):
        super().__init__(params)
        self.iters_per_pass = iters_per_pass
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
        th, tw, ipp = pick_config(
            H, W, tf.stencil_radius, tf.n_subiterations, n,
            cell_smem_bytes(grid.arrays, tf), device_limits(grid.device), self.iters_per_pass,
        )
        self.resolved_config = dict(
            window_mode="clamped", tile_rows=th, tile_cols=tw, iters_per_pass=ipp
        )
        lookup = self._tdv_lookup(grid)
        arrays = grid.arrays
        # Pass i writes into pass i-2's result: two buffers, never the input.
        earlier = [None, None]
        for i_pass in range(-(-n // ipp) if n else 0):
            arrays = tile_pass(
                arrays, tf, halo_cell,
                i_start=offset + i_pass * ipp, offset=offset, n_iterations=n,
                iters_per_pass=ipp, tile=(th, tw), out=earlier[i_pass % 2], tdv_lookup=lookup,
            )
            earlier[i_pass % 2] = arrays
        return Grid(arrays)
