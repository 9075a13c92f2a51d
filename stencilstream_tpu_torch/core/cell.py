"""Cell types: dataclasses of per-cell scalar fields.

A *cell* is the value stored at one grid position. A multi-field cell is a
dataclass declared with :func:`cell_type`; a whole grid of cells is the same
dataclass holding one ``(H, W)`` tensor per field (struct-of-arrays). A plain
tensor (Jacobi's ``float``, Conway's ``bool``) is a one-field cell and needs
no declaration.

Counterpart of ``stencilstream_tpu/core/cell.py``: where the JAX package maps
over cells with ``jax.tree``, this module offers :func:`cell_leaves`,
:func:`cell_map` and :func:`cell_unflatten` over dataclass fields.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, TypeVar

import numpy as np
import torch

T = TypeVar("T")

__all__ = [
    "E4M3_OVERFLOW",
    "NARROW_DTYPES",
    "cell_type",
    "cell_dtypes",
    "cell_zeros",
    "cell_full_grid",
    "canonicalize_cell",
    "cell_block_shape",
    "cell_field_names",
    "cell_leaves",
    "cell_map",
    "cell_unflatten",
    "scalar_dtype",
    "storage_scalar",
    "to_storage",
]

#: The narrow storage dtypes (``backends/storage_cast.py``) by their JAX
#: (numpy) names: cells stored in them are computed in float32.
NARROW_DTYPES = {"bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn}
#: Magnitudes above this round to NaN in float8 e4m3fn, as the JAX package
#: rounds them: 448 is the largest finite value and 464 the midpoint to the
#: next step, which rounds to even (448). PyTorch's own conversion
#: saturates to +-448 instead.
E4M3_OVERFLOW = 464.0


def cell_type(cls: type[T]) -> type[T]:
    """Declare a multi-field cell type (a dataclass whose fields are the
    cell's fields, in storage order)."""
    return dataclasses.dataclass(cls)


def _is_cell_class(x: Any) -> bool:
    return dataclasses.is_dataclass(x) and not isinstance(x, type)


def cell_field_names(cell: Any) -> tuple[str, ...]:
    """Field names in declaration order (``()`` for a one-field plain cell)."""
    if _is_cell_class(cell):
        return tuple(f.name for f in dataclasses.fields(cell))
    return ()


def cell_leaves(cell: Any) -> list:
    """The cell's field values in declaration order."""
    if _is_cell_class(cell):
        return [getattr(cell, f.name) for f in dataclasses.fields(cell)]
    return [cell]


def cell_unflatten(like: Any, leaves: list) -> Any:
    """Rebuild a cell of ``like``'s type from field values in order."""
    if _is_cell_class(like):
        names = cell_field_names(like)
        if len(leaves) != len(names):
            raise ValueError(f"expected {len(names)} fields, got {len(leaves)}")
        return type(like)(**dict(zip(names, leaves)))
    (leaf,) = leaves
    return leaf


def cell_map(fn: Callable[..., Any], *cells: Any) -> Any:
    """Apply ``fn`` field by field across cells of one structure."""
    first = cells[0]
    for other in cells[1:]:
        if cell_field_names(other) != cell_field_names(first):
            raise TypeError(
                f"cell structures differ: {type(first).__name__} vs {type(other).__name__}"
            )
    columns = zip(*(cell_leaves(c) for c in cells))
    return cell_unflatten(first, [fn(*col) for col in columns])


def scalar_dtype(x: Any) -> torch.dtype:
    """The dtype a field value is stored in. Python scalars take the JAX
    package's 32-bit defaults (int32, float32), so both packages agree."""
    if isinstance(x, torch.Tensor):
        return x.dtype
    if isinstance(x, bool):
        return torch.bool
    if isinstance(x, int):
        return torch.int32
    if isinstance(x, float):
        return torch.float32
    return torch.from_numpy(np.asarray(x)).dtype


def cell_dtypes(cell: Any) -> Any:
    """Cell of dtypes, one per field."""
    return cell_map(scalar_dtype, cell)


def cell_zeros(prototype: Any) -> Any:
    """A cell of Python zeros (``False`` for bool fields) matching
    ``prototype``'s fields."""
    return cell_map(lambda x: False if scalar_dtype(x) == torch.bool else 0, prototype)


def cell_full_grid(shape: tuple[int, int], cell: Any, *, device) -> Any:
    """Broadcast a scalar cell to a grid cell of ``shape`` tensors."""
    return cell_map(
        lambda x: torch.full(shape, _item(x), dtype=scalar_dtype(x), device=device), cell
    )


def _item(x: Any) -> Any:
    """A Python number from a 0-d tensor, a numpy scalar or a number."""
    return x.item() if hasattr(x, "item") else x


def to_storage(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` cast to the stored ``dtype`` as the JAX package casts it. A
    narrow dtype (:data:`NARROW_DTYPES`) rounds from float32 to nearest
    even; float8 e4m3fn gives NaN beyond :data:`E4M3_OVERFLOW` (and for
    infinities), where PyTorch's own cast would saturate. Any other dtype is
    ``x.to(dtype)``."""
    if dtype not in NARROW_DTYPES.values() or x.dtype == dtype:
        return x.to(dtype)
    x = x.to(torch.float32)
    if dtype == torch.float8_e4m3fn:
        x = torch.where(x.abs() > E4M3_OVERFLOW, torch.nan, x)
    return x.to(dtype)


def storage_scalar(value: Any, dtype: torch.dtype) -> Any:
    """A Python scalar rounded to ``dtype`` (a halo value): through float32
    for a narrow dtype, as the JAX package casts its float32 halo cell."""
    if dtype in NARROW_DTYPES.values():
        return to_storage(torch.tensor(_item(value), dtype=torch.float32), dtype).item()
    return torch.tensor(_item(value), dtype=dtype).item()


def canonicalize_cell(new: Any, like: Any) -> Any:
    """Cast ``new``'s fields to the dtypes (and shapes) of ``like``'s
    (:func:`to_storage`).

    Transition functions may compute in wider types or return scalars; the
    stored grid keeps its declared dtypes.
    """

    def one(n, l):
        if isinstance(n, torch.Tensor):
            n = to_storage(n, l.dtype)
            return n if n.shape == l.shape else n.expand(l.shape)
        return torch.full_like(l, storage_scalar(n, l.dtype))

    return cell_map(one, new, like)


def cell_block_shape(grid_cell: Any) -> tuple[int, ...]:
    """Shape of the fields of a grid cell (all fields must agree)."""
    leaves = cell_leaves(grid_cell)
    if not leaves:
        raise ValueError("cell has no fields")
    shape = tuple(leaves[0].shape)
    for leaf in leaves[1:]:
        if tuple(leaf.shape) != shape:
            raise ValueError(f"cell field arrays disagree in shape: {tuple(leaf.shape)} vs {shape}")
    return shape
