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
from one strip to the next in shared memory, so a walk never computes a row
twice. Grid edges are exact inside the kernel; there is no
band patch.

* On CPU tensors :func:`line_cache_pass` runs :func:`line_cache_pass_plain`
  (one tile pass's plain version: the same function).
* On CUDA tensors it launches the kernel, or raises.

Both read a step's time-dependent value from the call's TDV stream ``tdv``
(element ``i_abs - offset``), the inline strategy's when none is given.
"""

from __future__ import annotations

import ctypes
from typing import Any, NamedTuple

import torch

from ..core.cell import cell_field_names, cell_leaves
from ..tdv import tdv_stream
from .cuda_lib import (
    DeviceLimits,
    check,
    entry,
    fit_shared_memory,
    kernel_fields,
    pointer_array,
    require_device_op,
    tdv_pointer,
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
    "segment_rows",
    "launches",
]

#: Kernel launches made by :func:`line_cache_pass` (CUDA tensors only).
launches = 0

#: The line-cache geometry that ran fastest per iteration at 8192^2 on an
#: NVIDIA H100 80GB HBM3 at 700 W (``tile_sweep.py``, linecache part;
#: PERF.md), by the bytes of one cell's fields (variant and invariant):
#: ``(strip rows, window columns, halo r*p*k, CTAs per SM, waves)``. Jacobi
#: 4 B, HotSpot 8 B, Conway 1 B, the probe 20 B (five int32 fields, k=2);
#: FDTD's cells at 1024^2 (k=2), whose passes are short enough that the
#: host's call shows in the time per iteration: of two geometries within
#: 5% of each other, the one with more iterations a pass. Render 16 B
#: (strip 16, window 64, p=4: 95.6 us an iteration back to back, 82.7 us of
#: kernel, against 110 us of kernel at the 8 B entry's geometry) and coef
#: 32 B (strip 16, window 96, p=4: 50.5 us).
#: The window, core plus the halo on either side, is a whole number of
#: warps, so every level of the narrowing window covers the same 32-column
#: chunks; at another halo the law keeps the window and moves the panel.
#: Strips are whole runs (:data:`RUN_ROWS`). CTAs per SM: what the CUDA
#: occupancy calculator reported at that geometry (registers and shared
#: memory). Segments are cut so that the CTAs make ``waves`` waves: with
#: one wave, the CTAs that walk edge panels or the grid's top set the pass's
#: time.
LINE_LAW = {
    1: (32, 192, 8, 5, 2),
    4: (32, 160, 8, 4, 3),
    8: (32, 192, 8, 2, 3),
    16: (16, 64, 8, 4, 2),
    20: (8, 128, 4, 3, 3),
    32: (16, 96, 8, 2, 2),
}
#: Columns one warp covers: the narrowest panel the kernel takes.
WARP = 32
#: Rows of one thread's run for a one-field cell (``csrc/common.cuh``:
#: ``kRun``): a strip is a whole number of them.
RUN_ROWS = 8
#: Elements a shared row pitch is rounded up to (``kPitchAlign``).
PITCH_ALIGN = 16


def law_entry(cell_bytes: int):
    """The :data:`LINE_LAW` entry of the largest tabulated cell not larger
    than ``cell_bytes`` (the smallest one for a smaller cell)."""
    fits = [b for b in LINE_LAW if b <= cell_bytes]
    return LINE_LAW[max(fits) if fits else min(LINE_LAW)]


class LineCacheConfig(NamedTuple):
    strip_rows: int
    panel_cols: int
    segment_rows: int
    iters_per_pass: int


def line_cache_smem_bytes(
    strip_rows: int, panel_cols: int, radius: int, steps: int, variant_bytes: int, invariant_bytes: int
) -> int:
    """Dynamic shared memory of one CTA (``csrc/line_cache.cu``), rows of a
    pitch of ``panel + 2*hp`` columns rounded up to :data:`PITCH_ALIGN`,
    ``hp = r * steps``: per variant field two planes of ``2r + strip`` rows
    and ``steps - 1`` carries of ``2r`` rows; per invariant field one plane
    of ``strip + hp + r`` rows; plus 16 bytes for the alignment shift."""
    hp = radius * steps
    pitch = -(-(panel_cols + 2 * hp) // PITCH_ALIGN) * PITCH_ALIGN
    rows = variant_bytes * (2 * (strip_rows + 2 * radius) + max(steps - 1, 0) * 2 * radius)
    rows += invariant_bytes * (strip_rows + hp + radius)
    return rows * pitch + 16


def warmup_rows(radius: int, steps: int, strip_rows: int) -> int:
    """Rows a segment's walk starts above it (``csrc/line_cache.cu``):
    ``2*hp - 2r`` rounded up to whole strips."""
    return -(-max(0, 2 * radius * steps - 2 * radius) // strip_rows) * strip_rows


def ctas_per_sm(smem_bytes: int, limits: DeviceLimits, most: int) -> int:
    """Resident CTAs per SM the law counts on: as many as the shared memory
    holds, at least 1 and at most ``most`` (the law's)."""
    return max(1, min(most, limits.smem_per_block // smem_bytes))


def law_panel(width: int, halo: int, window: int) -> int:
    """Core columns of a panel at this halo: the window (``window``, or the
    whole warps the grid's width plus both halos needs when that is fewer)
    less both halos, and at least one warp."""
    window = min(window, -(-(width + 2 * halo) // WARP) * WARP)
    window = max(window, -(-(WARP + 2 * halo) // WARP) * WARP)
    return window - 2 * halo


def segment_rows(height: int, strip_rows: int, n_panels: int, slots: int, warmup: int) -> int:
    """Rows of a segment: as many segments per panel as ``slots`` CTAs
    (resident CTAs per SM x SMs x waves) hold, but none shorter than four
    warm-ups, nor than a strip; whole strips."""
    shortest = max(4 * warmup, strip_rows)
    n_segments = max(1, min(slots // n_panels, -(-height // shortest)))
    rows = -(-height // n_segments)
    return -(-rows // strip_rows) * strip_rows


def run_rows(arrays: Any, tf: Any) -> int:
    """Rows of one thread's run for this cell (``csrc/common.cuh``:
    ``run_rows``): :data:`RUN_ROWS` with one variant field, 1 with more.
    Without a device functor every field counts as variant."""
    names = cell_field_names(arrays)
    n_variant = len(getattr(tf, "cuda_variant", names)) if names else 1
    return RUN_ROWS if n_variant <= 1 else 1


def check_geometry(strip_rows: int, panel_cols: int, radius: int, run: int) -> None:
    """Raise ``ValueError`` for a geometry the kernel does not take: a strip
    that holds fewer than ``2r`` rows or is not a whole number of ``run``-row
    runs, a panel narrower than a warp."""
    if 2 * radius > strip_rows:
        raise ValueError(
            f"the line cache carries 2*radius rows from one strip to the next, so "
            f"strip_rows must be at least {2 * radius} (got {strip_rows})"
        )
    if strip_rows % run:
        raise ValueError(f"strip_rows must be a whole number of {run}-row runs (got {strip_rows})")
    if panel_cols < WARP:
        raise ValueError(f"panel_cols must be at least one warp, {WARP} columns (got {panel_cols})")


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

    * The :data:`LINE_LAW` entry for the cell's bytes gives the strip (unless
      ``strip_rows`` is given; it must hold the ``2r`` carried rows), the
      window, the halo, the CTAs per SM and the waves.
    * Unless given, the largest ``p`` whose halo ``r*p*k`` stays within the
      law's. Panels of :func:`law_panel`; then the window (down to two
      warps), the strip (when not given, down to one run) and ``p`` (when
      not given) shrink until a CTA fits half the shared memory a block may
      use.
    * Segments (:func:`segment_rows`): as many per panel as the law's waves
      of CTAs hold, at the law's CTAs per SM, or as many as the shared
      memory holds if fewer (:func:`ctas_per_sm`);
      :func:`line_cache_residency` asks the CUDA runtime what really
      resides, and ``chip_smoke.py`` logs it beside this count.

    Raises ``ValueError`` for a strip shorter than ``2r`` or a CTA that
    cannot fit.
    """
    strip, law_window, halo, ctas, waves = law_entry(variant_bytes + invariant_bytes)
    given_strip = strip_rows is not None
    T = int(strip_rows) if given_strip else strip
    check_geometry(T, WARP, radius, 1)
    auto_p = iters_per_pass is None
    p = max(1, halo // (radius * n_subiterations)) if auto_p else int(iters_per_pass)
    if n_iterations:
        p = min(p, n_iterations)

    def smem(geometry, p):
        T, window = geometry
        hp = radius * p * n_subiterations
        return line_cache_smem_bytes(
            T, law_panel(width, hp, window), radius, p * n_subiterations, variant_bytes, invariant_bytes
        )

    def shrink(geometry):
        T, window = geometry
        if window > 2 * WARP:
            return T, window - WARP
        if not given_strip and T // 2 >= max(RUN_ROWS, 2 * radius):
            return T // 2, window
        return None

    (T, window), p = fit_shared_memory(
        smem, (T, law_window), p, auto_p, shrink, limits,
        lambda g, p: f"a line-cache CTA of {g[0]} rows x a {g[1]}-column window at iters_per_pass={p}",
    )
    steps = p * n_subiterations
    panel = law_panel(width, radius * steps, window)
    slots = ctas_per_sm(smem((T, window), p), limits, ctas) * limits.sm_count * waves
    segment = segment_rows(height, T, -(-width // panel), slots, warmup_rows(radius, steps, T))
    return LineCacheConfig(T, panel, segment, p)


def line_cache_pass_plain(
    arrays: Any,
    tf: Any,
    halo_cell: Any,
    *,
    i_start: int,
    offset: int,
    n_iterations: int,
    iters_per_pass: int,
    tdv: Any = None,
) -> Any:
    """The plain PyTorch version of one pass: one tile pass's."""
    return tile_pass_plain(
        arrays, tf, halo_cell, i_start=i_start, offset=offset, n_iterations=n_iterations,
        iters_per_pass=iters_per_pass, tdv=tdv,
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
    tdv: Any = None,
) -> Any:
    """One pass; returns the new grid cell. ``tdv`` is the call's TDV
    stream (the inline strategy's when ``None``).

    The geometry (``strip_rows``, ``panel_cols``, ``segment_rows``) is the
    caller's, as :func:`pick_linecache_config` gives it to ``tiling``; it
    changes how the kernel walks the grid, not what the pass computes.
    Raises ``ValueError``, on the CPU too, for a strip that holds fewer than
    ``2r`` rows or is not a whole number of runs (:func:`run_rows`), and for
    a panel narrower than a warp.
    On the card the variant fields of the result are new tensors, or those of
    ``out`` (a cell from an earlier pass of the same chain, written in
    place; it must not be ``arrays``). The invariant fields of the result
    ARE the tensors of ``arrays``, so no caller may later write in place
    into a returned cell's fields without cloning them first.
    """
    global launches
    check_geometry(strip_rows, panel_cols, tf.stencil_radius, run_rows(arrays, tf))
    device = cell_leaves(arrays)[0].device
    if device.type == "cpu":
        return line_cache_pass_plain(
            arrays, tf, halo_cell, i_start=i_start, offset=offset,
            n_iterations=n_iterations, iters_per_pass=iters_per_pass, tdv=tdv,
        )
    fields = kernel_fields(arrays, tf, halo_cell, offset)
    if tdv is None:
        tdv = tdv_stream(tf, offset, n_iterations, device)
    H, W = fields.variant[0].shape
    dst = variant_outputs(arrays, fields, out)
    fn = entry("ss_line_cache_", fields.op)
    with torch.cuda.device(device):
        code = fn(
            pointer_array(fields.variant), pointer_array(dst), pointer_array(fields.invariant),
            H, W, strip_rows, panel_cols, segment_rows, iters_per_pass, i_start, offset,
            n_iterations, fields.params, fields.halo, tdv_pointer(tf, tdv, n_iterations, device),
            torch.cuda.current_stream(device).cuda_stream,
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
