"""Common StencilUpdate machinery shared by all backends.

Counterpart of ``stencilstream_tpu/backends/base.py``: construction from a
``Params`` struct, ``get_params()`` returning a live reference whose
mutations apply to the next call, a pure ``update(grid) -> grid`` call, and
the accumulated ``n_processed_cells`` / ``walltime`` counters.

There is no fallback: a kernel that fails to build or to launch raises.
"""

from __future__ import annotations

import time
from typing import Any

import torch

from ..core.cell import cell_dtypes, cell_field_names, cell_map, cell_zeros
from ..core.grid import Grid
from ..core.params import Params
from ..core.transition import validate_transition_function
from ..tdv import resolve_tdv_strategy
from .cuda_lib import require_device_op

__all__ = ["StencilUpdateBase", "resolve_halo"]


def resolve_halo(halo_value: Any, grid: Grid) -> Any:
    """Resolve ``Params.halo_value`` to a cell of Python scalars, each
    rounded to its grid field's dtype (default: the zero cell)."""
    if halo_value is None:
        return cell_zeros(grid.arrays)
    if cell_field_names(halo_value) != cell_field_names(grid.arrays):
        raise TypeError(
            f"halo_value structure {type(halo_value).__name__} does not match "
            f"the grid's cell structure {type(grid.arrays).__name__}"
        )
    return cell_map(
        lambda h, d: torch.tensor(h.item() if hasattr(h, "item") else h, dtype=d).item(),
        halo_value,
        cell_dtypes(grid.arrays),
    )


class StencilUpdateBase:
    """Base class for all stencil updaters."""

    Params = Params

    def __init__(self, params: Params):
        if isinstance(params, dict):
            params = self.Params(**params)
        validate_transition_function(params.transition_function)
        self.params = params
        self._n_processed_cells = 0
        self._walltime = 0.0

    # -- the updater contract ------------------------------------------------
    def get_params(self) -> Params:
        """Live parameter reference; changed fields apply to the next call."""
        return self.params

    def __call__(self, grid: Grid) -> Grid:
        """Compute ``n_iterations`` logical iterations and return the new
        grid. The input grid is never modified."""
        if not isinstance(grid, Grid):
            grid = Grid(grid)
        p = self.params
        start = time.perf_counter()
        out = self._update(grid)
        if p.blocking:
            out.block_until_ready()
        self._walltime += time.perf_counter() - start
        self._n_processed_cells += int(p.n_iterations) * grid.height * grid.width
        return out

    # -- metrics -------------------------------------------------------------
    def get_n_processed_cells(self) -> int:
        return self._n_processed_cells

    def get_walltime(self) -> float:
        return self._walltime

    # -- backend hook --------------------------------------------------------
    def _update(self, grid: Grid) -> Grid:
        raise NotImplementedError

    # -- shared helpers ------------------------------------------------------
    def _tdv_strategy(self):
        return resolve_tdv_strategy(self.params.tdv_strategy)

    def _tdv_stream(self, grid: Grid):
        """The current call's TDV stream on the grid's device (see
        :mod:`..tdv`): element ``i_rel`` is step ``i_rel``'s value."""
        p = self.params
        return self._tdv_strategy().prepare(
            p.transition_function, int(p.iteration_offset), int(p.n_iterations), grid.device
        )

    def require_device_op(self) -> str:
        """Check that the transition function can run on the CUDA kernels
        (``tiling`` and ``monotile`` do so for every CUDA grid) and return
        its device functor's name; raises ``NotImplementedError`` for one
        without a functor, or with a time-dependent value whose functor
        takes none."""
        return require_device_op(self.params.transition_function, self.params.iteration_offset)

    @property
    def transition_function(self):
        return self.params.transition_function
