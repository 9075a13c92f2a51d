"""The reference backend: plain PyTorch, the port's oracle.

Counterpart of ``stencilstream_tpu/backends/reference.py``. Each sub-step
materializes every neighbor the transition function touches as one
halo-framed shift of the field tensors, then applies the transition function
elementwise to whole tensors. It runs on any device, and it is what the CUDA
kernels' plain versions are built from.
"""

from __future__ import annotations

from typing import Any

from ..core.cell import canonicalize_cell, cell_field_names, cell_leaves, cell_map
from ..core.grid import Grid
from ..core.stencil import Stencil
from ..tdv import step_value
from .base import StencilUpdateBase, resolve_halo
from .fused import coordinates, shifted

__all__ = ["StencilUpdate", "apply_iterations"]


def single_subiteration(
    arrays: Any,
    tf: Any,
    halo_cell: Any,
    i_iteration: int,
    i_subiteration: int,
    tdv: Any,
    *,
    radius: int,
    grid_range: tuple[int, int] | None = None,
    origin: tuple[int, int] = (0, 0),
) -> Any:
    """One sub-iteration over a block of cells (pure function).

    ``grid_range``/``origin`` let a caller evaluate a *window* of a larger
    logical grid: ``origin`` is the global (row, col) of the block's first
    cell and ``grid_range`` the logical grid extent.
    """
    H, W = cell_leaves(arrays)[0].shape

    def neighbor(dr: int, dc: int):
        return cell_map(lambda a, hv: shifted(shifted(a, dr, 0, hv), dc, 1, hv), arrays, halo_cell)

    row, col = coordinates(H, W, origin[0], origin[1], cell_leaves(arrays)[0].device)
    stencil = Stencil(
        neighbor_fn=neighbor,
        radius=radius,
        id=(row, col),
        grid_range=grid_range if grid_range is not None else (H, W),
        iteration=i_iteration,
        subiteration=i_subiteration,
        time_dependent_value=tdv,
    )
    new = tf(stencil)
    if cell_field_names(new) != cell_field_names(arrays):
        raise TypeError(
            f"transition function returned cell {type(new).__name__}, "
            f"expected {type(arrays).__name__}"
        )
    return canonicalize_cell(new, arrays)


def run_iterations(
    arrays: Any,
    tf: Any,
    halo_cell: Any,
    offset: int,
    n_iterations: int,
    tdv_stream: Any,
) -> Any:
    """``n_iterations`` full iterations of ``tf`` over the whole grid; step
    ``i`` takes element ``i`` of the call's TDV stream."""
    for i in range(n_iterations):
        i_abs = offset + i
        tdv = step_value(tdv_stream, i)
        for sub in range(tf.n_subiterations):
            arrays = single_subiteration(
                arrays, tf, halo_cell, i_abs, sub, tdv, radius=tf.stencil_radius
            )
    return arrays


class StencilUpdate(StencilUpdateBase):
    """Plain PyTorch stencil updater (the oracle backend). It is
    differentiable: a field or a transition-function parameter that
    requires grad gives a result with its autograd graph."""

    differentiable = True

    def _update(self, grid: Grid) -> Grid:
        p = self.params
        return Grid(
            run_iterations(
                grid.arrays,
                p.transition_function,
                resolve_halo(p.halo_value, grid),
                int(p.iteration_offset),
                int(p.n_iterations),
                self._tdv_stream(grid),
            )
        )


def apply_iterations(
    grid: Grid,
    tf: Any,
    n_iterations: int,
    *,
    halo_value: Any = None,
    iteration_offset: int = 0,
) -> Grid:
    """Functional one-shot convenience: ``update(grid, offset, n) -> grid``."""
    update = StencilUpdate(
        StencilUpdate.Params(
            transition_function=tf,
            halo_value=halo_value,
            iteration_offset=iteration_offset,
            n_iterations=n_iterations,
        )
    )
    return update(grid)
