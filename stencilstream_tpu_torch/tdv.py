"""Time-dependent value (TDV) strategies.

Counterpart of ``stencilstream_tpu/tdv.py``, with the same three strategies
and the same interface: ``prepare(tf, offset, n, device) -> aux`` runs once
per update call, and ``lookup(tf, aux, i_rel, i_abs) -> tdv`` gives a step's
value (``i_rel`` is the 0-based step within the call, ``i_abs = offset +
i_rel``). Here ``aux`` is always the call's *TDV stream*: the values of all
``n`` iterations of the call, stacked along a leading axis on the grid's
device (``None`` for a transition function without a TDV). Every backend
reads this one stream, the plain PyTorch versions and the CUDA kernels
alike, so on the card they see the same bits; no kernel evaluates a TDV.

* :class:`InlineTDV` — one batched call of ``get_time_dependent_value`` with
  the tensor ``offset + arange(n)`` on the grid's device (the batch
  dimension written out where the JAX package traced the function into
  each step; the function must take a tensor of indices, as the JAX one had
  to be traceable).
* :class:`PrecomputeOnDeviceTDV` — the same batched call (the JAX package's
  ``vmap``).
* :class:`PrecomputeOnHostTDV` — an eager host loop, one plain Python call
  per iteration, stacked and moved to the device once. A function whose TDV
  is pure and batchable may set ``tdv_host_batchable = True`` to be
  evaluated in one batched call instead.

The CUDA kernels take a stream whose values are one tensor of the type their
device functor declares (``cuda_tdv``);
:meth:`~.backends.cuda_lib.Binding.stream_tdv` refuses any other.
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
    "step_value",
    "stream_to",
    "tdv_stream",
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


def step_value(stream: Any, i_rel: int) -> Any:
    """The TDV of step ``i_rel`` of a call: element ``i_rel`` of its stream."""
    return _tree_map(lambda a: a[i_rel], stream)


def stream_to(stream: Any, device) -> Any:
    """A TDV stream on ``device`` (a copy where it lies elsewhere)."""
    return _tree_map(lambda a: a.to(device), stream)


class TDVStrategy:
    """Interface; see module docstring."""

    def prepare(self, tf: Any, offset: int, n_iterations: int, device=None) -> Any:
        """The call's TDV stream (``None`` without a TDV)."""
        return None

    def lookup(self, tf: Any, aux: Any, i_rel: int, i_abs: int) -> Any:
        return step_value(aux, i_rel)


def _batched(tf: Any, offset: int, n_iterations: int, device) -> Any:
    """One call of ``get_time_dependent_value`` with the call's iteration
    indices; a value that does not depend on them is repeated n times. A
    function without a value (``None`` at the call's first iteration) costs
    no work on the device."""
    if tf.get_time_dependent_value(int(offset)) is None:
        return None
    idx = torch.arange(n_iterations, dtype=torch.int32, device=device) + int(offset)

    def along(a):
        a = torch.as_tensor(a, device=device)
        return a.expand(n_iterations) if a.dim() == 0 else a

    return _tree_map(along, tf.get_time_dependent_value(idx))


class InlineTDV(TDVStrategy):
    """One batched evaluation of the whole call's iterations on the grid's
    device."""

    def prepare(self, tf, offset, n_iterations, device=None):
        if n_iterations == 0:
            return None
        return _batched(tf, offset, n_iterations, device)


class PrecomputeOnDeviceTDV(InlineTDV):
    """Batched device precompute: the TDV of every iteration of the call in
    one evaluation, indexed per step."""


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


def tdv_stream(tf: Any, offset: int, n_iterations: int, device, strategy: Any = "inline") -> Any:
    """The TDV stream of a call of ``n_iterations`` from ``offset`` under
    ``strategy`` (default: inline), on ``device``."""
    return resolve_tdv_strategy(strategy).prepare(tf, int(offset), int(n_iterations), device)
