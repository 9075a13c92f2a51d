"""Durable grid checkpoints: pause a run in one process, resume it in another.

Counterpart of ``stencilstream_tpu/utils/checkpoint.py``, in the same file
layout, so that a file written by either package loads in the other: one
``.npz`` holding ``__iteration__`` (int64) and one array per field, keyed
``leaf{i}:{name}`` in the cell's field order, ``name`` being ``.{field}``
for a cell type and ``_`` for a one-field grid (the JAX package's pytree
key paths). A narrow field (bfloat16, float8 e4m3) is stored by its bits as
a void array (``|V2``, ``|V1``), as ``np.savez`` writes the JAX package's,
and is read back by the dtype of the prototype's field::

    save_checkpoint("ckpt.npz", grid, iteration=i)
    grid, i = load_checkpoint("ckpt.npz", like=grid_prototype)
    update.get_params().iteration_offset = i
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..core.cell import NARROW_DTYPES, cell_field_names, cell_leaves, cell_unflatten
from ..core.grid import Grid

__all__ = ["save_checkpoint", "load_checkpoint"]

#: A torch integer of a narrow field's width, to view its bits as.
_BITS = {1: torch.int8, 2: torch.int16}


def _leaf_names(arrays: Any) -> list[str]:
    return [f".{name}" for name in cell_field_names(arrays)] or ["_"]


def _stored(t: torch.Tensor) -> np.ndarray:
    """A field as the file holds it: a narrow one as a void array of its
    bits."""
    t = t.detach().cpu()
    if t.dtype in NARROW_DTYPES.values():
        return t.view(_BITS[t.element_size()]).numpy().view(f"V{t.element_size()}")
    return t.numpy()


def _loaded(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A stored array as a tensor on ``like``'s device; a void array as
    ``like``'s dtype, whose width it must have."""
    if a.dtype.kind == "V":
        if a.dtype.itemsize != like.element_size():
            raise ValueError(
                f"a field stored as {a.dtype.itemsize}-byte void cannot be read as {like.dtype}"
            )
        bits = torch.from_numpy(np.ascontiguousarray(a).view(f"i{a.dtype.itemsize}"))
        return bits.view(like.dtype).to(like.device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(like.device)


def save_checkpoint(path: str, grid: Grid, iteration: int = 0) -> None:
    """Write ``grid`` (a :class:`Grid` or a cell of tensors) and the
    iteration it has reached to ``path``."""
    arrays = grid.arrays if isinstance(grid, Grid) else grid
    leaves = [_stored(t) for t in cell_leaves(arrays)]
    np.savez(
        path,
        __iteration__=np.int64(iteration),
        **{f"leaf{i}:{n}": a for i, (n, a) in enumerate(zip(_leaf_names(arrays), leaves))},
    )


def load_checkpoint(path: str, like: Any) -> tuple[Grid, int]:
    """Load a checkpoint: ``(grid, iteration)``. ``like`` (a :class:`Grid`
    or a cell of tensors, of any shape) gives the cell's structure, the
    dtypes of narrow fields and the device the grid comes back on. Raises
    ``ValueError`` when the file holds another number of fields."""
    arrays = like.arrays if isinstance(like, Grid) else like
    prototypes = cell_leaves(arrays)
    with np.load(path) as data:
        iteration = int(data["__iteration__"])
        keys = sorted((k for k in data.files if k.startswith("leaf")), key=lambda k: int(k.split(":")[0][4:]))
        if len(keys) != len(prototypes):
            raise ValueError(f"checkpoint has {len(keys)} fields, expected {len(prototypes)}")
        leaves = [_loaded(data[k], p) for k, p in zip(keys, prototypes)]
    return Grid(cell_unflatten(arrays, leaves)), iteration
