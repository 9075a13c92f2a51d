"""One fused pass of ``iters_per_pass`` iterations over the whole grid.

Wrapper of the tile-pass CUDA kernel (``csrc/tile_pass.cu``), which replaces
the TPU strip-pass kernel (``stencilstream_tpu/backends/strip_pass.py``,
``StripPass.run``), and its plain PyTorch version.

* On CPU tensors :func:`tile_pass` runs :func:`tile_pass_plain` in the
  kernel's geometry: each tile from its own window, each sub-step over the
  window narrowed as the kernel narrows it (:func:`pass_narrowing`), built on
  :mod:`.fused`. Without a tile, :func:`tile_pass_plain` is the plain
  reference the kernel is held to: one whole-block sub-step at a time.
* On CUDA tensors it launches the kernel, or raises: for a transition
  function without a device functor, for a time-dependent value that its
  functor does not take or that cannot be streamed to it, and for fields
  the functor does not take.

Both compute ``iters_per_pass`` iterations starting at absolute iteration
``i_start``; iterations at or past ``offset + n_iterations`` leave the grid
unchanged (the last, partial pass of a call). Both read a step's
time-dependent value from the call's TDV stream ``tdv`` (element ``i_abs -
offset``; :mod:`..tdv`), the inline strategy's when none is given.

Clamped and extended mode. By default the cell is the whole grid (clamped
mode, the tiling backend's). In extended mode (the multi-device backends',
the TPU kernel's ``mode="extended"``) the cell is a *block* of a larger
grid: its first cell sits at global ``origin`` (which may be negative) in a
grid of ``grid_range`` cells, and it stores ``stored_halo = (rows, cols)``
cells on each side of its *core*, the part the pass returns. Cells outside
the grid present the halo value from the first sub-step on, whatever the
block holds there; the transition function sees global coordinates. A side
stores at least the pass's halo (:func:`pass_halo`), or the grid ends at or
inside that side of the block (:func:`check_block`).

The pass's halo. Each tile's window is its core and a compound halo per
side, ``r * p * k`` (:func:`.fused.halo_width`), or, for a functor that
declares each sub-step's reach (``cuda_reach``: the rows and columns it
reads below and above a cell, :func:`.cuda_lib.tile_reach`), the larger of
the low and the high reaches summed over the pass's sub-steps: ``p`` for
FDTD, whose sub-steps read one-sided. Sub-step s then computes the window
narrowed by the reaches of sub-steps 0..s on each side (:func:`pass_narrowing`).
"""

from __future__ import annotations

import ctypes
import itertools
from typing import Any

import torch

from .. import tracing
from ..core.cell import cell_field_names, cell_leaves, cell_map, cell_unflatten
from ..tdv import step_value, tdv_stream
from .cuda_lib import Binding, check, entry, op_info, require_device_op, tile_reach
from .fused import fused_substep, mask_out_of_grid

__all__ = [
    "bound_tile_pass", "check_block", "count_launch", "tile_pass", "tile_pass_plain", "tile_pass_residency",
    "tile_smem_bytes", "pass_halo", "pass_narrowing", "launches", "vector_launches", "inplace_launches",
    "reach_launches", "in_place_run_rows",
]

#: Kernel launches made by :func:`bound_tile_pass`, so by :func:`tile_pass` (CUDA
#: tensors only).
launches = 0
#: Those of them whose functor takes the vector thread map in its interior
#: sub-steps (``csrc/tile_pass.cu``: ``vector_map``; :func:`.cuda_lib.op_info`).
vector_launches = 0
#: Those of them whose functor's sub-steps update its cells in place
#: (``csrc/tile_pass.cu``: ``in_place``; :func:`.cuda_lib.op_info`'s ``writes``).
inplace_launches = 0
#: Those of them whose functor declares its sub-steps' reach, so that the
#: pass's halo is that reach summed (``csrc/tile_pass.cu``: ``pass_halo``;
#: :func:`.cuda_lib.op_info`'s ``reach``).
reach_launches = 0

#: Elements a shared-memory row pitch is rounded up to, and each plane's pad
#: (``csrc/common.cuh``: ``kPitchAlign``).
PITCH_ALIGN = 16
#: Columns one warp covers: the narrowest tile the kernel's thread map takes.
WARP = 32
#: Rows of one thread's run for a one-field cell (``csrc/common.cuh``:
#: ``kRun``): the shortest tile the kernel takes.
RUN_ROWS = 8
#: Rows of one thread's run in the vector thread map (``csrc/tile_pass.cu``:
#: ``kQuadRun``), whose lanes take 4 adjacent columns each.
QUAD_RUN = 8
#: Most rows of one thread's run in the in-place sub-steps
#: (``csrc/tile_pass.cu``: ``kInPlaceRun``), whose last run is not shifted
#: back inside the window, and the bytes of variant fields a run's outputs
#: may hold (``kInPlaceRunBytes``): :func:`in_place_run_rows`.
IN_PLACE_RUN = 4
IN_PLACE_RUN_BYTES = 64


def in_place_run_rows(variant_bytes: int) -> int:
    """Rows of one thread's run in the in-place sub-steps of a cell of
    ``variant_bytes`` bytes of variant fields (``csrc/tile_pass.cu``:
    ``in_place_run_rows``): as many as keep the run's outputs within
    :data:`IN_PLACE_RUN_BYTES`, at most :data:`IN_PLACE_RUN`, at least one.
    FDTD's 16 B take 4, convection's float64 64 and 80 B 1, its float32 32
    and 40 B 2 and 1."""
    return max(1, min(IN_PLACE_RUN, IN_PLACE_RUN_BYTES // variant_bytes))


def pass_narrowing(radius: int, iters_per_pass: int, n_subiterations: int,
                   reach: tuple[tuple[int, int], ...] | None = None) -> list[tuple[int, int]]:
    """How far each of a pass's ``p * k`` sub-steps narrows the tile pass's
    window, ``(lo, hi)`` cells on its low and its high side
    (``csrc/tile_pass.cu``: ``substep_in_place``): the low and the high
    reaches of sub-steps 0..s summed, each sub-step's ``reach`` given as
    ``(lo, hi)`` (:func:`.cuda_lib.tile_reach`), ``(r, r)`` where the
    functor declares none, so ``r * (s + 1)`` a side."""
    reach = reach or ((radius, radius),) * n_subiterations
    return list(itertools.accumulate(reach * iters_per_pass, lambda a, b: (a[0] + b[0], a[1] + b[1])))


def pass_halo(radius: int, iters_per_pass: int, n_subiterations: int,
              reach: tuple[tuple[int, int], ...] | None = None) -> int:
    """The tile pass's halo per side for a pass of ``iters_per_pass``
    iterations (``csrc/tile_pass.cu``: ``pass_halo``): the larger side of
    the pass's last narrowing (:func:`pass_narrowing`), so the compound-halo
    law ``r * p * k`` (:func:`.fused.halo_width`), or, given each sub-step's
    ``reach``, the larger of the low and the high reaches summed over the
    pass."""
    narrowing = pass_narrowing(radius, iters_per_pass, n_subiterations, reach)
    return max(narrowing[-1]) if narrowing else 0


def tile_smem_bytes(tile_h: int, tile_w: int, halo: int, cell_bytes: int) -> int:
    """Dynamic shared memory of one tile-pass CTA (``csrc/tile_pass.cu``):
    for each of the ``cell_bytes`` (:func:`.cuda_lib.tile_cell_smem_bytes`), one
    plane of window rows times a pitch of window columns rounded up to
    :data:`PITCH_ALIGN`, plus :data:`PITCH_ALIGN` elements."""
    pitch = -(-(tile_w + 2 * halo) // PITCH_ALIGN) * PITCH_ALIGN
    return cell_bytes * ((tile_h + 2 * halo) * pitch + PITCH_ALIGN)


def check_block(
    shape: tuple[int, int],
    origin: tuple[int, int],
    grid_range: tuple[int, int],
    stored_halo: tuple[int, int],
    halo: int,
) -> None:
    """Raise ``ValueError`` unless a block of ``shape`` stored cells at
    global ``origin`` in a grid of ``grid_range`` cells, with ``stored_halo``
    cells per side around its core, gives the exact core after a pass of
    halo ``halo`` (``r * p * k``): its core is not empty, and on each side
    it stores at least ``halo`` cells or the grid ends at or inside that
    side of the block."""
    (Hs, Ws), (r0, c0), (H, W), (hs, cs) = shape, origin, grid_range, stored_halo
    if hs < 0 or cs < 0 or Hs - 2 * hs < 1 or Ws - 2 * cs < 1:
        raise ValueError(f"a {Hs}x{Ws} block with a stored halo of {stored_halo} has no core")
    sides = {"top": hs >= halo or r0 <= 0, "bottom": hs >= halo or r0 + Hs >= H,
             "left": cs >= halo or c0 <= 0, "right": cs >= halo or c0 + Ws >= W}
    short = [side for side, ok in sides.items() if not ok]
    if short:
        raise ValueError(
            f"the block at {origin} stores {stored_halo} halo cells, fewer than the pass's halo {halo}, "
            f"on its {', '.join(short)} side(s), where the {H}x{W} grid goes on"
        )


def tile_pass_plain(
    arrays: Any,
    tf: Any,
    halo_cell: Any,
    *,
    i_start: int,
    offset: int,
    n_iterations: int,
    iters_per_pass: int,
    tdv: Any = None,
    origin: tuple[int, int] = (0, 0),
    grid_range: tuple[int, int] | None = None,
    stored_halo: tuple[int, int] = (0, 0),
    tile: tuple[int, int] | None = None,
) -> Any:
    """The plain PyTorch version of one pass: whole-block sub-steps with
    the halo value framing the block (:func:`.fused.fused_substep`), then
    the core; the reference the kernel is held to. Given the kernel's
    ``tile``, in the kernel's geometry instead (:func:`_windowed`): the CPU
    branch of :func:`tile_pass`. As in the kernel (and the TPU kernel), the
    fields a device functor only reads (those ``tf.cuda_variant`` does not
    name) come back as the input's core, bytes outside the grid included."""
    block = arrays
    Hs, Ws = cell_leaves(arrays)[0].shape
    grid_range = (Hs, Ws) if grid_range is None else tuple(grid_range)
    hs, cs = stored_halo
    halo = pass_halo(tf.stencil_radius, iters_per_pass, tf.n_subiterations, tile_reach(tf))
    check_block((Hs, Ws), origin, grid_range, stored_halo, halo)
    stream = tdv if tdv is not None else tdv_stream(tf, offset, n_iterations, cell_leaves(arrays)[0].device)
    # Steps past the call's last iteration pass the cells through.
    steps = [(i_abs, step_value(stream, i_abs - offset))
             for i_abs in range(i_start, min(i_start + iters_per_pass, offset + n_iterations))]
    core = (lambda a: a[hs : Hs - hs, cs : Ws - cs]) if hs or cs else (lambda a: a)
    if tile is not None:
        arrays = _windowed(arrays, tf, halo_cell, tile, halo, steps, origin, grid_range, stored_halo)
    else:
        if origin[0] < 0 or origin[1] < 0 or origin[0] + Hs > grid_range[0] or origin[1] + Ws > grid_range[1]:
            arrays = mask_out_of_grid(arrays, halo_cell, origin, grid_range)
        for i_abs, value in steps:
            arrays = fused_substep(
                arrays, tf, halo_cell, origin[0], origin[1], grid_range, i_abs, value,
                True, radius=tf.stencil_radius, n_subiterations=tf.n_subiterations,
            )
        arrays = cell_map(core, arrays)
    names, variant = cell_field_names(block), getattr(tf, "cuda_variant", None)
    if names and variant is not None:
        arrays = cell_unflatten(block, [
            a if name in variant else core(b)
            for name, a, b in zip(names, cell_leaves(arrays), cell_leaves(block))
        ])
    return arrays


def _windowed(
    block: Any,
    tf: Any,
    halo_cell: Any,
    tile: tuple[int, int],
    halo: int,
    steps: list,
    origin: tuple[int, int],
    grid_range: tuple[int, int],
    stored_halo: tuple[int, int],
) -> Any:
    """One pass in the kernel's geometry, in plain PyTorch: each
    ``tile``-sized core tile of the block is computed from its own window,
    the tile and ``halo`` cells a side, which holds the halo value wherever
    it lies outside the grid or the block, and sub-step s updates only the
    window narrowed as the kernel narrows it (:func:`pass_narrowing`); the
    cells past it keep their values, as in the kernel's in-place sub-steps.
    ``steps``: ``(iteration, time-dependent value)`` of each active step.
    Returns the core, every field's. With a halo short of the reach, the
    core's edge takes those kept values."""
    from .reference import single_subiteration

    r, k = tf.stencil_radius, tf.n_subiterations
    (Hs, Ws), (hs, cs), (th, tw), (H, W) = cell_leaves(block)[0].shape, stored_halo, tile, grid_range
    h, w = Hs - 2 * hs, Ws - 2 * cs
    wh, ww = th + 2 * halo, tw + 2 * halo

    def framed(a, hv):  # the block with room for every window around it
        out = torch.full((Hs + 2 * halo + th, Ws + 2 * halo + tw), hv, dtype=a.dtype, device=a.device)
        out[halo : halo + Hs, halo : halo + Ws] = a
        return out

    def narrowed(lo, hi):
        def update(old, new):
            old = old.clone()
            old[lo : wh - hi, lo : ww - hi] = new[lo : wh - hi, lo : ww - hi]
            return old
        return update

    room = cell_map(framed, block, halo_cell)
    out = cell_map(lambda a: torch.empty((h, w), dtype=a.dtype, device=a.device), block)
    for r0 in range(0, h, th):
        for c0 in range(0, w, tw):
            # The window's first cell: block (hs + r0 - halo, cs + c0 - halo).
            win = cell_map(lambda a: a[hs + r0 : hs + r0 + wh, cs + c0 : cs + c0 + ww], room)
            g0 = (origin[0] + hs + r0 - halo, origin[1] + cs + c0 - halo)
            inside = g0[0] >= 0 and g0[1] >= 0 and g0[0] + wh <= H and g0[1] + ww <= W
            if not inside:
                win = mask_out_of_grid(win, halo_cell, g0, (H, W))
            narrowing = iter(pass_narrowing(r, len(steps), k, tile_reach(tf)))
            for i_abs, value in steps:
                for sub in range(k):
                    new = single_subiteration(win, tf, halo_cell, i_abs, sub, value, radius=r, grid_range=(H, W),
                                              origin=g0)
                    if not inside:
                        new = mask_out_of_grid(new, halo_cell, g0, (H, W))
                    win = cell_map(narrowed(*next(narrowing)), win, new)
            nr, nc = min(th, h - r0), min(tw, w - c0)
            cell_map(lambda o, a: o[r0 : r0 + nr, c0 : c0 + nc].copy_(a[halo : halo + nr, halo : halo + nc]),
                     out, win)
    return out


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
    tdv: Any = None,
    origin: tuple[int, int] = (0, 0),
    grid_range: tuple[int, int] | None = None,
    stored_halo: tuple[int, int] = (0, 0),
) -> Any:
    """One pass over ``tile``-sized cores (``tiling.pick_config`` gives the
    law's); returns the new cell: the grid's (clamped mode), or the core of
    a block (extended mode, ``origin``/``grid_range``/``stored_halo``, see
    the module docstring). ``tdv`` is the call's TDV stream (the inline
    strategy's when ``None``). Binds the cell to its functor
    (:class:`.cuda_lib.Binding`) and makes the pass (:func:`bound_tile_pass`).

    On the card the variant fields of the result are new tensors, or those
    of ``out`` (a cell of the core's shape written in place: from an earlier
    pass of the same chain, or rows of a larger buffer; it must not overlap
    ``arrays``). On the CPU ``out`` is not written. The invariant
    fields of the result ARE the tensors of ``arrays`` (in extended mode,
    views of their cores), so no caller may later write in place into a
    returned cell's fields without cloning them first. Raises for a tile
    narrower than a warp or shorter than a run, and for a block whose
    stored halo is too narrow (:func:`check_block`).
    """
    call = Binding(arrays, tf, halo_cell, offset, n_iterations)
    call.stream_tdv(tdv_stream(tf, offset, n_iterations, call.device) if tdv is None else tdv)
    return bound_tile_pass(call, arrays, i_start=i_start, iters_per_pass=iters_per_pass, tile=tile, out=out,
                           origin=origin, grid_range=grid_range, stored_halo=stored_halo)


def bound_tile_pass(call: Binding, arrays: Any, *, i_start: int, iters_per_pass: int, tile: tuple[int, int],
                    out: Any = None, origin=(0, 0), grid_range=None, stored_halo=(0, 0)) -> Any:
    """:func:`tile_pass` on a call already bound (``call``: the pass loop
    of ``tiling`` binds once a call); ``arrays`` is the bound cell or an
    earlier pass's result. A ``kernels.launch`` span, whose ``halo`` is the
    pass's (:func:`pass_halo`). On the CPU, in the kernel's geometry
    (:func:`tile_pass_plain` given the ``tile``)."""
    with (tracing.span("kernels.launch", kernel="tile_pass", pass_index=(i_start - call.offset) // iters_per_pass)
          if tracing.on else tracing.OFF) as span:
        tf = call.tf
        reach = tile_reach(tf)
        halo = pass_halo(tf.stencil_radius, iters_per_pass, tf.n_subiterations, reach)
        if span is not None:
            span.attrs["halo"] = halo
        if call.op is None:
            return tile_pass_plain(
                arrays, tf, call.halo_cell, i_start=i_start, offset=call.offset, n_iterations=call.n_iterations,
                iters_per_pass=iters_per_pass, tdv=call.tdv, origin=tuple(origin), grid_range=grid_range,
                stored_halo=tuple(stored_halo), tile=tuple(tile),
            )
        Hs, Ws = cell_leaves(arrays)[0].shape
        H, W = (Hs, Ws) if grid_range is None else grid_range
        hs, cs = stored_halo
        check_block((Hs, Ws), origin, (H, W), (hs, cs), halo)
        h, w = Hs - 2 * hs, Ws - 2 * cs
        tile_h, tile_w = tile
        if tile_w < WARP or tile_h < RUN_ROWS:
            raise ValueError(f"the tile-pass kernel takes tiles of at least {RUN_ROWS}x{WARP} (got {tile})")
        new = call.launch(
            "ss_tile_pass_", arrays, out, Hs, Ws, origin[0], origin[1], H, W, hs, cs, h, w, tile_h, tile_w,
            iters_per_pass, i_start, call.offset, call.n_iterations, shape=(h, w),
            what=f"tile-pass kernel (tile {tile})",
        )
        thread_map = count_launch(call.op)
        if span is not None:
            span.attrs["map"] = thread_map
        if hs or cs:  # the invariant fields' cores beside the new (core) variant fields
            new = cell_map(lambda a: a if tuple(a.shape) == (h, w) else a[hs : Hs - hs, cs : Ws - cs], new)
        return new


def count_launch(op: str) -> str:
    """Count one launch of the kernel for device functor ``op`` in
    :data:`launches`, in :data:`reach_launches` if the functor declares its
    sub-steps' reach, and in :data:`vector_launches` if it takes the vector
    thread map or in :data:`inplace_launches` if its sub-steps update in
    place; returns the map, ``"vec4"``, ``"inplace"`` or ``"scalar"``."""
    global launches, vector_launches, inplace_launches, reach_launches
    launches += 1
    info = op_info(op)
    if info["reach"]:
        reach_launches += 1
    if info["vector_map"]:
        vector_launches += 1
        return "vec4"
    if info["writes"]:
        inplace_launches += 1
        return "inplace"
    return "scalar"


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
