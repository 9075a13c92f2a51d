"""The Grid: a 2D field of cells, stored struct-of-arrays.

Counterpart of ``stencilstream_tpu/core/grid.py``: a cell of ``(H, W)``
tensors, one per field, all on one device. Every constructor takes the
device explicitly.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .cell import NARROW_DTYPES, cell_block_shape, cell_full_grid, cell_leaves, cell_map, cell_zeros

__all__ = ["Grid", "synchronize"]

#: A torch integer of a narrow field's width in bytes, to view its bits as.
_BITS = {1: torch.int8, 2: torch.int16}


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    """A tensor on ``device`` from a numpy array; a narrow one by its bits."""
    dtype = NARROW_DTYPES.get(a.dtype.name)
    if dtype is None:
        return torch.tensor(a, device=device)
    return torch.tensor(a.view(f"i{a.itemsize}"), device=device).view(dtype)


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A numpy array of a tensor; a narrow one as its unsigned bits."""
    t = t.detach().cpu()
    if t.dtype not in NARROW_DTYPES.values():
        return t.numpy()
    return t.view(_BITS[t.element_size()]).numpy().view(f"u{t.element_size()}")


class Grid:
    """A 2D grid of cells. ``arrays`` is a cell of ``(H, W)`` tensors."""

    __slots__ = ("arrays",)

    def __init__(self, arrays: Any):
        self.arrays = arrays

    # -- constructors --------------------------------------------------------
    @classmethod
    def full(cls, height: int, width: int, cell: Any, *, device) -> "Grid":
        """Grid of ``height x width`` cells, every cell equal to ``cell``."""
        return cls(cell_full_grid((height, width), cell, device=device))

    @classmethod
    def zeros(cls, height: int, width: int, cell_prototype: Any, *, device) -> "Grid":
        return cls.full(height, width, cell_zeros(cell_prototype), device=device)

    @classmethod
    def from_numpy(cls, arrays: Any, *, device) -> "Grid":
        """Build a grid from a cell of numpy ``(H, W)`` arrays. Arrays whose
        dtype is named ``bfloat16`` or ``float8_e4m3fn`` (the JAX package's
        narrow storage, numpy extension types) come in through their
        bits."""
        grid = cls(cell_map(lambda a: _tensor(np.asarray(a), device), arrays))
        cell_block_shape(grid.arrays)  # validate agreeing shapes
        return grid

    # -- geometry ------------------------------------------------------------
    @property
    def shape(self) -> tuple[int, int]:
        return cell_block_shape(self.arrays)[:2]

    @property
    def height(self) -> int:
        return self.shape[0]

    @property
    def width(self) -> int:
        return self.shape[1]

    @property
    def range(self) -> tuple[int, int]:
        """``(height, width)``."""
        return self.shape

    @property
    def device(self) -> torch.device:
        return cell_leaves(self.arrays)[0].device

    def make_similar(self) -> "Grid":
        """A zero grid with the same geometry, dtypes and device."""
        return Grid(cell_map(torch.zeros_like, self.arrays))

    # -- host access ---------------------------------------------------------
    def cell_at(self, r: int, c: int) -> Any:
        """Read one cell to the host (numpy scalars)."""
        return cell_map(lambda a: a[r, c].cpu().numpy(), self.arrays)

    def set_cell(self, r: int, c: int, cell: Any) -> "Grid":
        """Functional single-cell update (host-side initialization helper)."""

        def one(a, v):
            a = a.clone()
            a[r, c] = v
            return a

        return Grid(cell_map(one, self.arrays, cell))

    def to_numpy(self) -> Any:
        """Cell of numpy arrays. A bfloat16 field comes back as its bits
        (``uint16``), a float8 e4m3fn field as ``uint8`` bits: numpy has no
        such types of its own (a view as the JAX package's numpy type
        restores one)."""
        return cell_map(_numpy, self.arrays)

    def block_until_ready(self) -> "Grid":
        """Wait until the device has finished writing this grid."""
        synchronize(self.device)
        return self

    def __repr__(self) -> str:
        h, w = self.shape
        n = len(cell_leaves(self.arrays))
        return f"Grid({h}x{w}, {n} field{'s' if n != 1 else ''}, {self.device})"


def synchronize(device: torch.device) -> None:
    """Wait until ``device`` has finished its queued work (a CPU device has
    none)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
