"""Common StencilUpdate machinery shared by all backends.

Counterpart of ``stencilstream_tpu/backends/base.py``: construction from a
``Params`` struct, ``get_params()`` returning a live reference whose
mutations apply to the next call, a pure ``update(grid) -> grid`` call, and
the accumulated ``n_processed_cells`` / ``walltime`` counters.

There is no fallback: a kernel that fails to build or to launch raises.
Only ``reference`` is differentiable; every other backend raises on a grid
or a transition function that carries a tensor requiring grad
(:func:`check_no_grad`), since the CUDA kernels have no backward.
"""

from __future__ import annotations

import dataclasses
import time
import types
from collections.abc import Mapping
from typing import Any

import torch

from .. import tracing
from ..core.cell import cell_dtypes, cell_field_names, cell_leaves, cell_map, cell_zeros, storage_scalar
from ..core.grid import Grid, synchronize
from ..core.params import Params
from ..core.transition import validate_transition_function
from ..tdv import resolve_tdv_strategy
from .cuda_lib import require_device_op

__all__ = ["StencilUpdateBase", "check_no_grad", "resolve_halo"]


def resolve_halo(halo_value: Any, grid: Grid) -> Any:
    """Resolve ``Params.halo_value`` to a cell of Python scalars, each
    rounded to its grid field's dtype, a narrow one through float32
    (default: the zero cell)."""
    if halo_value is None:
        return cell_zeros(grid.arrays)
    if cell_field_names(halo_value) != cell_field_names(grid.arrays):
        raise TypeError(
            f"halo_value structure {type(halo_value).__name__} does not match "
            f"the grid's cell structure {type(grid.arrays).__name__}"
        )
    return cell_map(storage_scalar, halo_value, cell_dtypes(grid.arrays))


def _grad_tensors(value: Any, seen: set[int] | None = None) -> bool:
    """Whether ``value`` is, or holds at any depth of containers, mappings
    and attributes, a tensor that requires grad."""
    if isinstance(value, torch.Tensor):
        return value.requires_grad
    if isinstance(value, (type, types.ModuleType)):
        return False
    seen = set() if seen is None else seen
    if id(value) in seen:
        return False
    seen.add(id(value))
    if isinstance(value, Mapping):
        items = value.values()
    elif isinstance(value, (tuple, list, set, frozenset)):
        items = value
    elif dataclasses.is_dataclass(value):
        items = [getattr(value, f.name) for f in dataclasses.fields(value)]
    elif hasattr(value, "__dict__"):
        items = vars(value).values()
    else:
        return False
    return any(_grad_tensors(v, seen) for v in items)


def check_no_grad(grid: Grid, tf: Any, backend: str) -> None:
    """Raise ``NotImplementedError`` when grad mode is on and a field of
    ``grid`` or a parameter of ``tf`` is a tensor that requires grad:
    ``backend`` runs CUDA kernels, which have no backward, so its result
    would silently drop the gradient. The ``reference`` backend
    differentiates. Under ``torch.no_grad()`` a detached result is what was
    asked for, and nothing is checked."""
    if not torch.is_grad_enabled():
        return
    names = cell_field_names(grid.cells()[0]) or ("",)
    fields = [n for j, n in enumerate(names) if any(_grad_tensors(cell_leaves(c)[j]) for c in grid.cells())]
    what = [f"field {n!r}" if n else "the grid" for n in fields]
    if _grad_tensors(tf):
        what.append(f"a parameter of {type(tf).__name__}")
    if what:
        raise NotImplementedError(
            f"the {backend!r} backend runs the CUDA kernels, which have no backward, but "
            f"{' and '.join(what)} requires grad; differentiate through the 'reference' backend"
        )


class StencilUpdateBase:
    """Base class for all stencil updaters."""

    Params = Params
    #: Whether a call carries autograd graphs (``reference`` only).
    differentiable = False

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
        with tracing.call(self, grid) if tracing.on else tracing.OFF:
            if not self.differentiable:
                with tracing.span("entry.check_no_grad") if tracing.on else tracing.OFF:
                    check_no_grad(grid, p.transition_function, type(self).__module__.rpartition(".")[2])
            start = time.perf_counter()
            out = self._update(grid)
            if p.blocking:
                with tracing.span("entry.sync") if tracing.on else tracing.OFF:
                    for device in self._devices(out):
                        synchronize(device)
            self._walltime += time.perf_counter() - start
        self._n_processed_cells += int(p.n_iterations) * grid.height * grid.width
        return out

    # -- metrics -------------------------------------------------------------
    def get_n_processed_cells(self) -> int:
        return self._n_processed_cells

    def get_walltime(self) -> float:
        return self._walltime

    # -- backend hooks -------------------------------------------------------
    def _update(self, grid: Grid) -> Grid:
        raise NotImplementedError

    def _devices(self, out: Grid) -> list:
        """The devices a call ran on; a blocking call's walltime ends once
        each has finished (the multi-device backends name their mesh's)."""
        return [out.device]

    # -- shared helpers ------------------------------------------------------
    def _tdv_strategy(self):
        return resolve_tdv_strategy(self.params.tdv_strategy)

    def _tdv_stream(self, grid: Grid):
        """The current call's TDV stream on the grid's device (see
        :mod:`..tdv`): element ``i_rel`` is step ``i_rel``'s value."""
        p = self.params
        strategy = self._tdv_strategy()
        offset, n = int(p.iteration_offset), int(p.n_iterations)
        span = (tracing.span("backends.tdv", strategy=type(strategy).__name__, offset=offset, n=n)
                if tracing.on else tracing.OFF)
        with span:
            return strategy.prepare(p.transition_function, offset, n, grid.device)

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
