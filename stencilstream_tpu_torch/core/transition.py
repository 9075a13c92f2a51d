"""Transition function contract.

Counterpart of ``stencilstream_tpu/core/transition.py``. A transition
function is a Python object with:

* class attributes ``stencil_radius`` (int >= 1) and ``n_subiterations``
  (int >= 1),
* ``__call__(stencil) -> cell`` — pure, written with elementwise ``torch``
  operations against the tensor-valued
  :class:`~stencilstream_tpu_torch.core.stencil.Stencil`,
* ``get_time_dependent_value(i_iteration)`` — pure; defaults to ``None``.

Declare runtime parameters with the :func:`transition_function` decorator (a
dataclass). They stay mutable fields: the plain PyTorch path reads them on
every call, and on the card they reach the kernel as scalar launch
arguments, never as constants compiled into it, so mutating a parameter
between calls (``update.get_params().transition_function.dt = ...``) never
rebuilds a kernel.

A transition function runs on the card's kernels when it names a device
functor: ``cuda_op`` (the ``csrc/ops/<name>.cuh`` functor),
``cuda_variant`` (the cell fields the functor updates; every other field is
loop-invariant and is never written) and ``cuda_params()`` (its scalar
fields in the functor's order). See
:func:`stencilstream_tpu_torch.backends.cuda_lib.require_device_op`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, TypeVar

T = TypeVar("T")

__all__ = [
    "transition_function",
    "static_field",
    "BaseTransitionFunction",
    "validate_transition_function",
]

_STATIC_MARK = "stencilstream_static"


def static_field(default=dataclasses.MISSING, **kwargs):
    """A dataclass field marked structural (not a runtime parameter)."""
    metadata = dict(kwargs.pop("metadata", {}) or {})
    metadata[_STATIC_MARK] = True
    return dataclasses.field(default=default, metadata=metadata, **kwargs)


def transition_function(cls: type[T]) -> type[T]:
    """Declare a transition function's runtime parameters (a dataclass)."""
    return dataclasses.dataclass(cls)


class BaseTransitionFunction:
    """Defaults that disable the advanced features: radius 1, one
    sub-iteration, no time-dependent value."""

    stencil_radius: int = 1
    n_subiterations: int = 1

    def get_time_dependent_value(self, i_iteration):
        return None


def validate_transition_function(tf: Any) -> None:
    """Runtime check of the transition-function contract."""
    radius = getattr(tf, "stencil_radius", None)
    if not isinstance(radius, int) or radius < 1:
        raise TypeError(
            f"transition function {type(tf).__name__} must define an integer "
            f"class attribute stencil_radius >= 1 (got {radius!r})"
        )
    n_sub = getattr(tf, "n_subiterations", None)
    if not isinstance(n_sub, int) or n_sub < 1:
        raise TypeError(
            f"transition function {type(tf).__name__} must define an integer "
            f"class attribute n_subiterations >= 1 (got {n_sub!r})"
        )
    if not callable(tf):
        raise TypeError(f"transition function {type(tf).__name__} must be callable")
    if not callable(getattr(tf, "get_time_dependent_value", None)):
        raise TypeError(
            f"transition function {type(tf).__name__} must define "
            f"get_time_dependent_value(i_iteration) (inherit BaseTransitionFunction "
            f"for the no-TDV default)"
        )

