"""Plain building blocks of a fused multi-iteration window update.

Counterpart of ``stencilstream_tpu/backends/fused.py``: the halo law, the
halo-framed neighbor shift, the out-of-grid mask, one fused sub-step over a
window whose edges carry the halo value ("pad" on both axes), and
:func:`fused_window_pass`, several fused iterations over a window whose axes
each either "pad" or "shrink". These are what the plain PyTorch versions of
the CUDA kernels and the multi-device backends' plain local compute are
built from; the kernels themselves (``csrc/``) compute the same function.

Per-axis window disciplines:

* ``"pad"`` — neighbors beyond the window's edge are the halo value (the
  window edge is the grid edge, or its margin goes stale by ``radius`` cells
  per sub-step and the caller discards it);
* ``"shrink"`` — the window loses ``radius * n_subiterations`` cells per
  side per iteration, so a window of ``core + 2 * radius * p *
  n_subiterations`` yields the exact core after ``p`` fused iterations.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..core.cell import cell_leaves, cell_map

__all__ = ["fused_substep", "fused_window_pass", "halo_width", "mask_out_of_grid", "shifted"]


def halo_width(radius: int, iters_per_pass: int, n_subiterations: int) -> int:
    """Window halo per side for a fused pass — the compound-halo law
    ``r * p * n_subiterations``."""
    return radius * iters_per_pass * n_subiterations


def shifted(a: torch.Tensor, d: int, axis: int, hv: Any) -> torch.Tensor:
    """Shape-preserving shift: ``out[i] = a[i + d]`` along ``axis``, with the
    halo value ``hv`` where ``i + d`` runs past the array."""
    if d == 0:
        return a
    n = a.shape[axis]
    shape = list(a.shape)
    shape[axis] = min(abs(d), n)
    frame = torch.full(shape, hv, dtype=a.dtype, device=a.device)
    if abs(d) >= n:
        return frame
    if d > 0:
        return torch.cat([a.narrow(axis, d, n - d), frame], dim=axis)
    return torch.cat([frame, a.narrow(axis, 0, n + d)], dim=axis)


def coordinates(h: int, w: int, row0: int, col0: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Global (row, col) int32 coordinates of an ``(h, w)`` window whose
    first cell sits at ``(row0, col0)`` (broadcast views, no copies)."""
    row = (torch.arange(h, dtype=torch.int32, device=device) + row0)[:, None].expand(h, w)
    col = (torch.arange(w, dtype=torch.int32, device=device) + col0)[None, :].expand(h, w)
    return row, col


def mask_out_of_grid(
    window: Any,
    halo_cell: Any,
    origin: tuple[int, int],
    grid_range: tuple[int, int],
) -> Any:
    """Replace out-of-grid window positions with the halo value."""
    h, w = cell_leaves(window)[0].shape
    H, W = grid_range
    row, col = coordinates(h, w, origin[0], origin[1], cell_leaves(window)[0].device)
    oog = (row < 0) | (row >= H) | (col < 0) | (col >= W)
    return cell_map(lambda a, hv: torch.where(oog, torch.full_like(a, hv), a), window, halo_cell)


def fused_substep(
    window: Any,
    tf: Any,
    halo_cell: Any,
    row0: int,
    col0: int,
    grid_range: tuple[int, int],
    i_abs: int,
    tdv: Any,
    active: bool,
    *,
    radius: int,
    n_subiterations: int,
) -> Any:
    """One fused iteration (all ``n_subiterations`` phases) over a window.

    Neighbors are halo-framed shifts of the window (the window edge presents
    the halo value). ``active`` False passes cells through unchanged (a step
    past the call's last iteration). Out-of-grid window positions are
    re-masked to the halo value after every sub-step; a window inside the
    grid has none.
    """
    from .reference import single_subiteration

    if not active:
        return window
    H, W = grid_range
    h, w = cell_leaves(window)[0].shape
    in_grid = row0 >= 0 and col0 >= 0 and row0 + h <= H and col0 + w <= W
    for sub in range(n_subiterations):
        window = single_subiteration(
            window, tf, halo_cell, i_abs, sub, tdv,
            radius=radius, grid_range=grid_range, origin=(row0, col0),
        )
        if not in_grid:
            window = mask_out_of_grid(window, halo_cell, (row0, col0), grid_range)
    return window


def fused_window_pass(
    window: Any,
    tf: Any,
    halo_cell: Any,
    origin: tuple[int, int],
    grid_range: tuple[int, int],
    i_start: int,
    i_target: int,
    tdv_lookup: Callable[[int, int], Any],
    *,
    radius: int,
    n_subiterations: int,
    n_steps: int,
    row_mode: str = "shrink",
    col_mode: str = "pad",
) -> Any:
    """Apply ``n_steps`` fused iterations to a window of cells.

    ``origin`` is the global (row, col) of the window's first cell and
    ``grid_range`` the logical grid extent ``(H, W)``. Out-of-grid window
    positions present the halo value from the first sub-step on, whatever
    they held (a mesh-edge exchange fills them with zeros). Step ``s`` is
    absolute iteration ``i_start + s``; steps at or past ``i_target`` pass
    cells through unchanged (a ``"shrink"`` axis still loses its margin),
    and only the others read their time-dependent value,
    ``tdv_lookup(s, i_abs)``. A ``"shrink"`` axis must exceed
    ``2 * radius * n_steps * n_subiterations``. Returns the final window.
    """
    for mode in (row_mode, col_mode):
        if mode not in ("pad", "shrink"):
            raise ValueError(f"window modes are 'pad' or 'shrink' (got {mode!r})")
    row0, col0 = origin
    window = mask_out_of_grid(window, halo_cell, (row0, col0), grid_range)
    r, k = radius, n_subiterations
    # A shrinking axis is computed as a padded one and then loses the
    # iteration's margin: cells r*k or more from the window's edge read only
    # taps that the shrinking window holds too.
    dr = r * k * (row_mode == "shrink")
    dc = r * k * (col_mode == "shrink")
    for step in range(n_steps):
        i_abs = i_start + step
        active = i_abs < i_target
        window = fused_substep(
            window, tf, halo_cell, row0, col0, grid_range, i_abs,
            tdv_lookup(step, i_abs) if active else None, active,
            radius=r, n_subiterations=k,
        )
        h, w = cell_leaves(window)[0].shape
        window = cell_map(lambda a: a[dr : h - dr, dc : w - dc], window)
        row0, col0 = row0 + dr, col0 + dc
    return window
