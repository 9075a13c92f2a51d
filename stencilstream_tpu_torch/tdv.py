"""Time-dependent value (TDV) strategies.

Counterpart of ``stencilstream_tpu/tdv.py``, with the same three strategies
and the same interface: ``prepare(tf, offset, n, device) -> aux`` runs once
per update call, and ``lookup(tf, aux, i_rel, i_abs) -> tdv`` runs per step
(``i_rel`` is the 0-based step within the call, ``i_abs = offset + i_rel``).

* :class:`InlineTDV` — call ``get_time_dependent_value(i_abs)`` in each step.
* :class:`PrecomputeOnDeviceTDV` — one batched call with a tensor of all
  iteration indices of the call (the batch dimension written out where the
  JAX package used ``vmap``), on the grid's device; steps index into it.
* :class:`PrecomputeOnHostTDV` — an eager host loop, one plain Python call
  per iteration, stacked and moved to the device once. A function whose TDV
  is pure and batchable may set ``tdv_host_batchable = True`` to be
  evaluated in one batched call instead.

The CUDA kernels of this package take no TDV yet; the ``tiling`` and
``monotile`` backends refuse a transition function with one on a CUDA grid.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

__all__ = [
    "TDVStrategy",
    "InlineTDV",
    "PrecomputeOnDeviceTDV",
    "PrecomputeOnHostTDV",
    "resolve_tdv_strategy",
]


def _tree_map(fn: Callable[..., Any], *xs: Any) -> Any:
    """Map over a TDV value: ``None``, a tuple/list, a dataclass or a leaf."""
    first = xs[0]
    if first is None:
        return None
    if isinstance(first, (tuple, list)):
        return type(first)(_tree_map(fn, *parts) for parts in zip(*xs))
    if dataclasses.is_dataclass(first) and not isinstance(first, type):
        names = [f.name for f in dataclasses.fields(first)]
        return type(first)(
            **{n: _tree_map(fn, *(getattr(x, n) for x in xs)) for n in names}
        )
    return fn(*xs)


class TDVStrategy:
    """Interface; see module docstring."""

    def prepare(self, tf: Any, offset: int, n_iterations: int, device=None) -> Any:
        return None

    def lookup(self, tf: Any, aux: Any, i_rel: int, i_abs: int) -> Any:
        raise NotImplementedError


class InlineTDV(TDVStrategy):
    def lookup(self, tf, aux, i_rel, i_abs):
        return tf.get_time_dependent_value(i_abs)


def _batched(tf: Any, offset: int, n_iterations: int, device) -> Any:
    idx = torch.arange(n_iterations, dtype=torch.int32, device=device) + int(offset)
    return tf.get_time_dependent_value(idx)


class PrecomputeOnDeviceTDV(TDVStrategy):
    """Batched device precompute: ``aux`` holds the TDV of every iteration
    of the call, indexed per step."""

    def prepare(self, tf, offset, n_iterations, device=None):
        if n_iterations == 0:
            return None
        return _batched(tf, offset, n_iterations, device)

    def lookup(self, tf, aux, i_rel, i_abs):
        if aux is None:
            return tf.get_time_dependent_value(i_abs)
        return _tree_map(lambda a: a[i_rel], aux)


class PrecomputeOnHostTDV(TDVStrategy):
    """Host precompute — ``get_time_dependent_value`` may run arbitrary,
    impure host code; it is called once per iteration, in order."""

    def prepare(self, tf, offset, n_iterations, device=None):
        if n_iterations == 0:
            return None
        if getattr(tf, "tdv_host_batchable", False):
            return _batched(tf, offset, n_iterations, device)
        values = [tf.get_time_dependent_value(int(offset + i)) for i in range(n_iterations)]
        if values[0] is None:
            return None
        return _tree_map(
            lambda *xs: torch.from_numpy(np.stack([np.asarray(x) for x in xs])).to(device),
            *values,
        )

    def lookup(self, tf, aux, i_rel, i_abs):
        if aux is None:
            return None
        return _tree_map(lambda a: a[i_rel], aux)


_NAMED = {
    "inline": InlineTDV,
    "precompute_on_device": PrecomputeOnDeviceTDV,
    "precompute_on_host": PrecomputeOnHostTDV,
}


def resolve_tdv_strategy(strategy) -> TDVStrategy:
    if isinstance(strategy, TDVStrategy):
        return strategy
    if isinstance(strategy, str):
        try:
            return _NAMED[strategy]()
        except KeyError:
            raise ValueError(
                f"unknown TDV strategy {strategy!r}; expected one of {sorted(_NAMED)}"
            ) from None
    if isinstance(strategy, type) and issubclass(strategy, TDVStrategy):
        return strategy()
    raise TypeError(f"cannot resolve TDV strategy from {strategy!r}")
