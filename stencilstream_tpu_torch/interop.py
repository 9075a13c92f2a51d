"""Carry state from the JAX package into the port.

The caller converts on the JAX side — a transition function's fields with
``dataclasses.asdict`` and a grid with ``Grid.to_numpy()`` — and this module
turns those numpy values into the port's objects on a given device, so both
packages compute from identical inputs. It never imports JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from .core.grid import Grid
from .models import jacobi
from .models.hotspot import HotspotCell, HotspotKernel
from .probe import ProbeCell

__all__ = [
    "grid_from_numpy",
    "transition_function_from_fields",
    "conway_grid",
    "hotspot_grid",
    "hotspot_kernel",
    "jacobi_kernel",
    "probe_grid",
]


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
