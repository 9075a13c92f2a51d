"""Plain building blocks of a fused multi-iteration window update.

Counterpart of the plain helpers of ``stencilstream_tpu/backends/fused.py``:
the halo law, the halo-framed neighbor shift, the out-of-grid mask and one
fused sub-step over a window whose edges carry the halo value ("pad" on both
axes). These are what the plain PyTorch versions of the CUDA kernels are
built from; the kernels themselves (``csrc/``) compute the same function.
"""

from __future__ import annotations

from typing import Any

import torch

from ..core.cell import cell_leaves, cell_map

__all__ = ["fused_substep", "halo_width", "mask_out_of_grid", "shifted"]


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
