"""Automatic backend selection.

Counterpart of ``stencilstream_tpu/backends/auto.py``: a runtime dispatch
per grid,

* more than one visible device and a grid large enough that the per-device
  halo padding does not dominate (at least 64 rows a device, or a grid
  that does not fit the monotile capacity law) -> ``distributed``;
* the grid fits the monotile capacity law (:func:`.monotile.monotile_plan`,
  from the device's SM count and shared memory per block) -> ``monotile``;
* otherwise -> ``tiling``.

The monotile plan the choice was made by goes to the ``monotile`` delegate,
which plans no second time. Visible devices are
``torch.cuda.device_count()`` for a CUDA grid and one for a CPU grid. A CPU
grid is judged by an H100 SXM's limits, so it resolves as it would on that
card. Construction kwargs are forwarded to
whichever backend is chosen, filtered to the parameters its constructor
accepts.
"""

from __future__ import annotations

import inspect
from typing import Any

import torch

from .. import tracing
from ..core.grid import Grid
from . import distributed, monotile, tiling
from .base import StencilUpdateBase
from .cuda_lib import cell_smem_bytes, device_limits

__all__ = ["StencilUpdate", "choose_backend"]


def choose_backend(grid: Grid, tf: Any, n_devices: int | None = None) -> str:
    """Resolve the backend name for a grid (see module docstring)."""
    return _choose(grid, tf, n_devices)[0]


def _choose(grid: Grid, tf: Any, n_devices: int | None = None) -> tuple[str, monotile.MonotilePlan | None]:
    """The backend name for a grid and the monotile plan it was chosen by
    (``None`` where the grid does not fit)."""
    if n_devices is None:
        n_devices = torch.cuda.device_count() if grid.device.type == "cuda" else 1
    H, W = grid.shape
    plan = monotile.monotile_plan(
        H, W, tf.stencil_radius, cell_smem_bytes(grid.arrays, tf), device_limits(grid.device)
    )
    if n_devices > 1 and (H / n_devices >= 64 or plan is None):
        return "distributed", plan
    return ("monotile" if plan is not None else "tiling"), plan


class StencilUpdate(StencilUpdateBase):
    """Auto-dispatching stencil updater.

    Delegates are cached per backend name; ``resolved_backend`` exposes the
    last choice and ``resolved_config`` the chosen backend's own (``None``
    for ``monotile``, which has no options).
    """

    def __init__(self, params, **backend_kwargs):
        super().__init__(params)
        self._backend_kwargs = backend_kwargs
        self._delegates: dict[str, StencilUpdateBase] = {}
        self.resolved_backend: str | None = None
        self.resolved_config: dict | None = None

    def _delegate_for(self, name: str) -> StencilUpdateBase:
        delegate = self._delegates.get(name)
        if delegate is None:
            cls = {"monotile": monotile.StencilUpdate, "tiling": tiling.StencilUpdate,
                   "distributed": distributed.StencilUpdate}[name]
            accepted = set(inspect.signature(cls.__init__).parameters)
            kwargs = {k: v for k, v in self._backend_kwargs.items() if k in accepted}
            delegate = cls(self.params, **kwargs)
            self._delegates[name] = delegate
        delegate.params = self.params
        return delegate

    def __call__(self, grid):
        if not isinstance(grid, Grid):
            grid = Grid(grid)
        with tracing.call(self, grid) if tracing.on else tracing.OFF:
            with tracing.span("backends.choose") if tracing.on else tracing.OFF as choice:
                name, plan = _choose(grid, self.params.transition_function)
                delegate = self._delegate_for(name)
                if name == "monotile":
                    delegate._given_plan = plan  # the delegate's call plans no second time
                if choice is not None:
                    choice.attrs["backend"] = name
            self.resolved_backend = name
            out = delegate(grid)
        self.resolved_config = getattr(delegate, "resolved_config", None)
        self._walltime = sum(d.get_walltime() for d in self._delegates.values())
        self._n_processed_cells = sum(d.get_n_processed_cells() for d in self._delegates.values())
        return out
