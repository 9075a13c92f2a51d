"""One line-cache pass of ``iters_per_pass`` iterations over the whole grid.

Wrapper of the line-cache CUDA kernel (``csrc/line_cache.cu``), which
replaces the TPU line-cache kernel (``stencilstream_tpu/backends/
line_cache.py``, ``LineCachePass.run``), its plain PyTorch version and its
configuration law.

The kernel computes the same function as one tile pass
(:mod:`.tile_pass`): ``iters_per_pass`` iterations from absolute iteration
``i_start``, those at or past ``offset + n_iterations`` leaving the grid
unchanged, out-of-grid cells at the halo value. It gets there differently:
one CTA per (column panel, row segment) walks its segment top to bottom a
strip of rows at a time, carrying each sub-step level's bottom ``2r`` rows
from one strip to the next in shared memory, so a walk never reads or
computes a row twice. Grid edges are exact inside the kernel; there is no
band patch.

* On CPU tensors :func:`line_cache_pass` runs :func:`line_cache_pass_plain`
  (one tile pass's plain version: the same function).
* On CUDA tensors it launches the kernel, or raises.
"""

from __future__ import annotations

import ctypes
from typing import Any, Callable, NamedTuple

import torch

from ..core.cell import cell_leaves
from .cuda_lib import (
    DeviceLimits,
    check,
    entry,
    fit_shared_memory,
    kernel_fields,
    pointer_array,
    require_device_op,
    variant_outputs,
    with_variant,
)
from .tile_pass import tile_pass_plain

__all__ = [
    "LineCacheConfig",
    "line_cache_pass",
    "line_cache_pass_plain",
    "line_cache_residency",
    "line_cache_smem_bytes",
    "pick_linecache_config",
    "launches",
]

#: Kernel launches made by :func:`line_cache_pass` (CUDA tensors only).
launches = 0

#: Rows staged per step of a walk. The carry copies (2r rows per level) and
#: the barrier per level are paid once per strip, so a taller strip pays
#: less for them; at 32 one float32 field at p=8 takes some 27 KB per CTA.
DEFAULT_STRIP = 32
#: Core columns per CTA, as the tile pass's tiles; the window adds r*p*k
#: recomputed columns per side.
DEFAULT_PANEL = 64
#: Resident CTAs per SM the law aims for: the kernel runs 256 threads, and an
#: SM holds at most 2048.
MAX_CTAS_PER_SM = 8


class LineCacheConfig(NamedTuple):
    strip_rows: int
    panel_cols: int
    segment_rows: int
    iters_per_pass: int


def line_cache_smem_bytes(
    strip_rows: int, panel_cols: int, radius: int, steps: int, variant_bytes: int, invariant_bytes: int
) -> int:
    """Dynamic shared memory of one CTA (``csrc/line_cache.cu``): per
    variant field two ``(2r + strip)``-row planes and ``steps`` carries of
    ``2r`` rows, per invariant field two ``(strip + hp + 2r)``-row planes,
    all ``panel + 2*hp`` wide, ``hp = r * steps``."""
    hp = radius * steps
    width = panel_cols + 2 * hp
    rows = variant_bytes * (2 * (strip_rows + 2 * radius) + steps * 2 * radius)
    rows += invariant_bytes * 2 * (strip_rows + hp + 2 * radius)
    return rows * width


def warmup_rows(radius: int, steps: int, strip_rows: int) -> int:
    """Rows a segment's walk starts above it (``csrc/line_cache.cu``):
    ``2*hp + 2r`` rounded up to whole strips."""
    return -(-(2 * radius * steps + 2 * radius) // strip_rows) * strip_rows


def ctas_per_sm(smem_bytes: int, limits: DeviceLimits) -> int:
    """Resident CTAs per SM the law counts on: as many as the shared memory
    holds, at least 2 and at most :data:`MAX_CTAS_PER_SM`."""
    return max(2, min(MAX_CTAS_PER_SM, limits.smem_per_block // smem_bytes))


def pick_linecache_config(
    height: int,
    width: int,
    radius: int,
    n_subiterations: int,
    n_iterations: int,
    variant_bytes: int,
    invariant_bytes: int,
    limits: DeviceLimits,
    iters_per_pass: int | None = None,
    strip_rows: int | None = None,
) -> LineCacheConfig:
    """The line-cache geometry for a grid, from the device's limits.

    * ``strip_rows`` 32 unless given; it must hold the ``2r`` carried rows.
    * Panels of 64 core columns (fewer for a narrower grid) and, unless
      given, the largest ``p`` whose halo ``r*p*k`` stays within an eighth
      of the panel; then ``p`` (and, at ``p = 1`` or a given ``p``, the
      panel, down to 32 columns) shrinks until a CTA fits half the shared
      memory a block may use.
    * Segments: as many per panel as one wave of CTAs holds (as many CTAs
      per SM as fit, at least 2 and at most 8), but no segment shorter than
      four warm-ups, nor than a strip. "Fit" counts threads and shared
      memory only, not registers; :func:`line_cache_residency` asks the
      CUDA runtime what really resides, and ``chip_smoke.py`` logs it beside
      this count.

    Raises ``ValueError`` when ``2r`` exceeds the strip or a CTA cannot fit.
    """
    T = DEFAULT_STRIP if strip_rows is None else int(strip_rows)
    if 2 * radius > T:
        raise ValueError(
            f"the line cache carries 2*radius rows from one strip to the next, so "
            f"strip_rows must be at least {2 * radius} (got {T})"
        )
    panel = min(DEFAULT_PANEL, -(-width // 32) * 32)
    auto_p = iters_per_pass is None
    p = max(1, panel // (8 * radius * n_subiterations)) if auto_p else int(iters_per_pass)
    if n_iterations:
        p = min(p, n_iterations)

    def smem(panel, p):
        return line_cache_smem_bytes(T, panel, radius, p * n_subiterations, variant_bytes, invariant_bytes)

    panel, p = fit_shared_memory(
        smem, panel, p, auto_p, lambda panel: panel // 2 if panel > 32 else None, limits,
        lambda panel, p: f"a line-cache CTA of {T} rows x {panel} columns at iters_per_pass={p}",
    )
    per_sm = ctas_per_sm(smem(panel, p), limits)
    n_panels = -(-width // panel)
    shortest = 4 * warmup_rows(radius, p * n_subiterations, T)
    n_segments = max(1, min(per_sm * limits.sm_count // n_panels, -(-height // shortest)))
    rows = -(-height // n_segments)
    return LineCacheConfig(T, panel, -(-rows // T) * T, p)


def line_cache_pass_plain(
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
    """The plain PyTorch version of one pass: one tile pass's."""
    return tile_pass_plain(
        arrays, tf, halo_cell, i_start=i_start, offset=offset, n_iterations=n_iterations,
        iters_per_pass=iters_per_pass, tdv_lookup=tdv_lookup,
    )


@torch.no_grad()
def line_cache_pass(
    arrays: Any,
    tf: Any,
    halo_cell: Any,
    *,
    i_start: int,
    offset: int,
    n_iterations: int,
    iters_per_pass: int,
    strip_rows: int,
    panel_cols: int,
    segment_rows: int,
    out: Any = None,
    tdv_lookup: Callable[[int, int], Any] | None = None,
) -> Any:
    """One pass; returns the new grid cell.

    The geometry (``strip_rows``, ``panel_cols``, ``segment_rows``) is the
    caller's, as :func:`pick_linecache_config` gives it to ``tiling``; it
    changes how the kernel walks the grid, not what the pass computes.
    On the card the variant fields of the result are new tensors, or those of
    ``out`` (a cell from an earlier pass of the same chain, written in
    place; it must not be ``arrays``). The invariant fields of the result
    ARE the tensors of ``arrays``, so no caller may later write in place
    into a returned cell's fields without cloning them first. Raises
    ``ValueError`` when ``2r`` exceeds ``strip_rows``.
    """
    global launches
    if 2 * tf.stencil_radius > strip_rows:
        raise ValueError(
            f"strip_rows must be at least 2*radius = {2 * tf.stencil_radius} (got {strip_rows})"
        )
    device = cell_leaves(arrays)[0].device
    if device.type == "cpu":
        return line_cache_pass_plain(
            arrays, tf, halo_cell, i_start=i_start, offset=offset,
            n_iterations=n_iterations, iters_per_pass=iters_per_pass, tdv_lookup=tdv_lookup,
        )
    fields = kernel_fields(arrays, tf, halo_cell, offset)
    H, W = fields.variant[0].shape
    dst = variant_outputs(arrays, fields, out)
    fn = entry("ss_line_cache_", fields.op)
    with torch.cuda.device(device):
        code = fn(
            pointer_array(fields.variant), pointer_array(dst), pointer_array(fields.invariant),
            H, W, strip_rows, panel_cols, segment_rows, iters_per_pass, i_start, offset,
            n_iterations, fields.params, fields.halo, torch.cuda.current_stream(device).cuda_stream,
        )
    check(code, "line-cache kernel")
    launches += 1
    return with_variant(arrays, fields, dst)


def line_cache_residency(tf: Any, strip_rows: int, panel_cols: int, iters_per_pass: int, device) -> int:
    """CTAs of the line-cache kernel for ``tf``'s functor that one SM of the
    CUDA ``device`` holds at once at this geometry and a full pass, as the
    CUDA runtime's occupancy calculator reports it (registers, threads and
    shared memory)."""
    blocks = ctypes.c_int()
    fn = entry("ss_line_cache_residency_", require_device_op(tf))
    with torch.cuda.device(device):
        code = fn(strip_rows, panel_cols, iters_per_pass * tf.n_subiterations, ctypes.byref(blocks))
    check(code, "line-cache occupancy query")
    return blocks.value
