"""Carry state from the JAX package into the port.

The caller converts on the JAX side — a transition function's fields with
``dataclasses.asdict`` and a grid with ``Grid.to_numpy()`` — and this module
turns those numpy values into the port's objects on a given device, so both
packages compute from identical inputs. A time-dependent value crosses as a
numpy stream of per-iteration values (:class:`StreamTDV`). Narrow storage
crosses by name (:func:`cast_storage_kernel`) and narrow grids by their bits
(``Grid.from_numpy``). It never imports JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .backends.storage_cast import CastStorageKernel
from .core.cell import NARROW_DTYPES
from .core.grid import Grid
from .models import convection, fdtd, jacobi
from .models.hotspot import HotspotCell, HotspotKernel
from .probe import ProbeCell
from .tdv import PrecomputeOnHostTDV

__all__ = [
    "StreamTDV",
    "cast_storage_kernel",
    "convection_experiment",
    "convection_folded_grid",
    "convection_folded_pt_kernel",
    "convection_grid",
    "convection_pt_kernel",
    "convection_thermal_kernel",
    "conway_grid",
    "fdtd_grid",
    "fdtd_kernel",
    "grid_from_numpy",
    "hotspot_grid",
    "hotspot_kernel",
    "jacobi_kernel",
    "probe_grid",
    "transition_function_from_fields",
]


def cast_storage_kernel(inner: Any, storage: str = "bfloat16") -> CastStorageKernel:
    """The port's :class:`~.backends.storage_cast.CastStorageKernel` around
    the port's ``inner`` transition function, for the storage dtype a JAX
    ``CastStorageKernel`` names (``"bfloat16"`` or ``"float8_e4m3fn"``)."""
    return CastStorageKernel(inner, NARROW_DTYPES[str(storage)])


def _as_dict(values: Any) -> dict:
    if dataclasses.is_dataclass(values) and not isinstance(values, type):
        return {f.name: getattr(values, f.name) for f in dataclasses.fields(values)}
    return dict(values)


def transition_function_from_fields(cls: type, fields: Any) -> Any:
    """An instance of the port's transition-function class ``cls`` with the
    given field values (a dict, or a dataclass of numpy scalars). Numpy
    scalars keep their dtype, so float32 parameters stay float32."""
    return cls(**_as_dict(fields))


def grid_from_numpy(cell_cls: type | None, arrays: Any, *, device) -> Grid:
    """A port :class:`Grid` on ``device`` from a cell of numpy arrays (a
    JAX-side cell dataclass or a dict); ``cell_cls`` ``None`` for a
    one-field grid given as one array."""
    if cell_cls is None:
        return Grid.from_numpy(np.asarray(arrays), device=device)
    fields = {k: np.asarray(v) for k, v in _as_dict(arrays).items()}
    return Grid.from_numpy(cell_cls(**fields), device=device)


def hotspot_kernel(fields: Any) -> HotspotKernel:
    """The port's :class:`HotspotKernel` from a JAX one's fields."""
    return transition_function_from_fields(HotspotKernel, fields)


def hotspot_grid(arrays: Any, *, device) -> Grid:
    """The port's HotSpot grid from a JAX HotSpot grid's ``to_numpy()``."""
    return grid_from_numpy(HotspotCell, arrays, device=device)


def jacobi_kernel(variant: str, fields: Any) -> Any:
    """The port's Jacobi ``variant`` from a JAX one's fields (Jacobi9's
    ``coef`` stays a tuple)."""
    values = _as_dict(fields)
    if "coef" in values and isinstance(values["coef"], (list, tuple)):
        values["coef"] = tuple(values["coef"])
    return transition_function_from_fields(jacobi.VARIANTS[variant], values)


def conway_grid(cells: Any, *, device) -> Grid:
    """The port's Conway grid (one bool field) from a JAX grid's
    ``to_numpy()``."""
    return grid_from_numpy(None, np.asarray(cells, dtype=bool), device=device)


def probe_grid(arrays: Any, *, device) -> Grid:
    """The port's probe grid from a JAX probe grid's ``to_numpy()``."""
    return grid_from_numpy(ProbeCell, arrays, device=device)


def fdtd_kernel(resolver_name: str, fields: Any) -> fdtd.FDTDKernel:
    """The port's :class:`~.models.fdtd.FDTDKernel` from a JAX one's fields
    (its ``resolver`` is replaced by the port's resolver of that name; its
    ``resolver_state``, a dict of arrays or ``None``, arrives as numpy)."""
    values = _as_dict(fields)
    state = values.get("resolver_state")
    if state is not None:
        state = {k: np.asarray(v) for k, v in state.items()}
    values.update(resolver=fdtd.RESOLVERS[resolver_name](), resolver_state=state)
    return transition_function_from_fields(fdtd.FDTDKernel, values)


def fdtd_grid(resolver_name: str, arrays: Any, *, device) -> Grid:
    """The port's FDTD grid for a resolver from a JAX FDTD grid's
    ``to_numpy()``."""
    return grid_from_numpy(fdtd.RESOLVERS[resolver_name].MaterialCell, arrays, device=device)


def convection_experiment(fields: Any) -> convection.Experiment:
    """The port's convection :class:`~.models.convection.Experiment` from a
    JAX one's fields."""
    return convection.Experiment(**_as_dict(fields))


def convection_grid(arrays: Any, *, device) -> Grid:
    """The port's convection grid (float32 or float64, as given) from a JAX
    convection grid's ``to_numpy()``."""
    return grid_from_numpy(convection.ThermalConvectionCell, arrays, device=device)


def convection_pt_kernel(fields: Any) -> convection.PseudoTransientKernel:
    """The port's pseudo-transient kernel from a JAX one's fields
    (``with_err`` included); its parameters' dtype names the functor's."""
    return transition_function_from_fields(convection.PseudoTransientKernel, fields)


def convection_folded_grid(arrays: Any, *, device) -> Grid:
    """The port's folded convection grid (the 11 fields and the coordinate
    planes, bool masks included) from a JAX folded grid's ``to_numpy()``."""
    return grid_from_numpy(convection.FoldedConvectionCell, arrays, device=device)


def convection_folded_pt_kernel(fields: Any) -> convection.FoldedPseudoTransientKernel:
    """The port's folded pseudo-transient kernel from a JAX one's fields
    (``with_err`` included)."""
    return transition_function_from_fields(convection.FoldedPseudoTransientKernel, fields)


def convection_thermal_kernel(fields: Any) -> convection.ThermalSolverKernel:
    """The port's thermal kernel from a JAX one's fields."""
    return transition_function_from_fields(convection.ThermalSolverKernel, fields)


class StreamTDV(PrecomputeOnHostTDV):
    """A precompute-on-host TDV strategy (``Params.tdv_strategy``) whose
    values come from a numpy stream, such as the JAX package's amplitudes:
    iteration ``i`` takes ``values[i - first_iteration]``, whatever the
    transition function's own ``get_time_dependent_value`` says."""

    def __init__(self, values: Any, first_iteration: int = 0):
        self.values = np.array(values)  # a writable copy, which torch can share
        self.first_iteration = int(first_iteration)

    def prepare(self, tf, offset, n_iterations, device=None):
        if n_iterations == 0:
            return None
        lo = int(offset) - self.first_iteration
        if lo < 0 or lo + n_iterations > len(self.values):
            raise ValueError(
                f"the stream holds iterations {self.first_iteration}.."
                f"{self.first_iteration + len(self.values) - 1}; the call needs "
                f"{offset}..{offset + n_iterations - 1}"
            )
        return torch.from_numpy(np.ascontiguousarray(self.values[lo : lo + n_iterations])).to(device)
