"""One fused pass of ``iters_per_pass`` iterations over the whole grid.

Wrapper of the tile-pass CUDA kernel (``csrc/tile_pass.cu``), which replaces
the TPU strip-pass kernel (``stencilstream_tpu/backends/strip_pass.py``,
``StripPass.run``), and its plain PyTorch version.

* On CPU tensors :func:`tile_pass` runs :func:`tile_pass_plain`: the same
  function, one whole-grid sub-step at a time, built on :mod:`.fused`.
* On CUDA tensors it launches the kernel, or raises: for a transition
  function without a device functor, for one with a time-dependent value,
  and for fields the functor does not take.

Both compute ``iters_per_pass`` iterations starting at absolute iteration
``i_start``; iterations at or past ``offset + n_iterations`` leave the grid
unchanged (the last, partial pass of a call).
"""

from __future__ import annotations

import ctypes
from typing import Any, Callable

import torch

from ..core.cell import cell_leaves
from .cuda_lib import (
    check,
    entry,
    kernel_fields,
    pointer_array,
    require_device_op,
    variant_outputs,
    with_variant,
)
from .fused import fused_substep

__all__ = ["tile_pass", "tile_pass_plain", "tile_pass_residency", "tile_smem_bytes", "launches"]

#: Kernel launches made by :func:`tile_pass` (CUDA tensors only).
launches = 0

#: Elements a shared-memory row pitch is rounded up to, and each plane's pad
#: (``csrc/common.cuh``: ``kPitchAlign``).
PITCH_ALIGN = 16
#: Columns one warp covers: the narrowest tile the kernel's thread map takes.
WARP = 32
#: Rows of one thread's run for a one-field cell (``csrc/common.cuh``:
#: ``kRun``): the shortest tile the kernel takes.
RUN_ROWS = 8


def tile_smem_bytes(tile_h: int, tile_w: int, halo: int, cell_bytes: int) -> int:
    """Dynamic shared memory of one tile-pass CTA (``csrc/tile_pass.cu``):
    for each of the ``cell_bytes`` (:func:`.cuda_lib.cell_smem_bytes`), one
    plane of window rows times a pitch of window columns rounded up to
    :data:`PITCH_ALIGN`, plus :data:`PITCH_ALIGN` elements."""
    pitch = -(-(tile_w + 2 * halo) // PITCH_ALIGN) * PITCH_ALIGN
    return cell_bytes * ((tile_h + 2 * halo) * pitch + PITCH_ALIGN)


def tile_pass_plain(
    arrays: Any,
    tf: Any,
    halo_cell: Any,
    *,
    i_start: int,
    offset: int,
    n_iterations: int,
    iters_per_pass: int,
    tdv_lookup: Callable[[int, int], Any] | None = None,
) -> Any:
    """The plain PyTorch version of one pass."""
    H, W = cell_leaves(arrays)[0].shape
    for step in range(iters_per_pass):
        i_abs = i_start + step
        if i_abs >= offset + n_iterations:
            break  # pass-through for the rest of the pass
        tdv = (
            tdv_lookup(i_abs - offset, i_abs)
            if tdv_lookup is not None
            else tf.get_time_dependent_value(i_abs)
        )
        arrays = fused_substep(
            arrays, tf, halo_cell, 0, 0, (H, W), i_abs, tdv, True,
            radius=tf.stencil_radius, n_subiterations=tf.n_subiterations,
        )
    return arrays


@torch.no_grad()
def tile_pass(
    arrays: Any,
    tf: Any,
    halo_cell: Any,
    *,
    i_start: int,
    offset: int,
    n_iterations: int,
    iters_per_pass: int,
    tile: tuple[int, int],
    out: Any = None,
    tdv_lookup: Callable[[int, int], Any] | None = None,
) -> Any:
    """One pass over ``tile``-sized cores (``tiling.pick_config`` gives the
    law's); returns the new grid cell.

    On the card the variant fields of the result are new tensors, or those
    of ``out`` (a cell from an earlier pass of the same chain, written in
    place; it must not be ``arrays``). The invariant fields of the result
    ARE the tensors of ``arrays``, so no caller may later write in place
    into a returned cell's fields without cloning them first. Raises for a
    tile narrower than a warp or shorter than a run.
    """
    global launches
    device = cell_leaves(arrays)[0].device
    if device.type == "cpu":
        return tile_pass_plain(
            arrays, tf, halo_cell, i_start=i_start, offset=offset,
            n_iterations=n_iterations, iters_per_pass=iters_per_pass, tdv_lookup=tdv_lookup,
        )
    fields = kernel_fields(arrays, tf, halo_cell, offset)
    H, W = fields.variant[0].shape
    dst = variant_outputs(arrays, fields, out)
    tile_h, tile_w = tile
    if tile_w < WARP or tile_h < RUN_ROWS:
        raise ValueError(f"the tile-pass kernel takes tiles of at least {RUN_ROWS}x{WARP} (got {tile})")
    fn = entry("ss_tile_pass_", fields.op)
    with torch.cuda.device(device):
        code = fn(
            pointer_array(fields.variant), pointer_array(dst), pointer_array(fields.invariant),
            H, W, tile_h, tile_w, iters_per_pass, i_start, offset, n_iterations,
            fields.params, fields.halo, torch.cuda.current_stream(device).cuda_stream,
        )
    check(code, f"tile-pass kernel (tile {tile})")
    launches += 1
    return with_variant(arrays, fields, dst)


def tile_pass_residency(tf: Any, tile: tuple[int, int], iters_per_pass: int, device) -> int:
    """CTAs of the tile-pass kernel for ``tf``'s functor that one SM of the
    CUDA ``device`` holds at once at this tile and ``p``, as the CUDA
    runtime's occupancy calculator reports it (registers, threads and
    shared memory)."""
    blocks = ctypes.c_int()
    fn = entry("ss_tile_pass_residency_", require_device_op(tf))
    with torch.cuda.device(device):
        code = fn(tile[0], tile[1], iters_per_pass, ctypes.byref(blocks))
    check(code, "tile-pass occupancy query")
    return blocks.value
