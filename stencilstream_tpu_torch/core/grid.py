"""The Grid: a 2D field of cells, stored struct-of-arrays.

Counterpart of ``stencilstream_tpu/core/grid.py``: a cell of ``(H, W)``
tensors, one per field, all on one device. Every constructor takes the
device explicitly.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .cell import cell_block_shape, cell_full_grid, cell_leaves, cell_map, cell_zeros

__all__ = ["Grid"]


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
        """Build a grid from a cell of numpy ``(H, W)`` arrays."""
        grid = cls(cell_map(lambda a: torch.tensor(np.asarray(a), device=device), arrays))
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
        """Cell of numpy arrays."""
        return cell_map(lambda a: a.detach().cpu().numpy(), self.arrays)

    def block_until_ready(self) -> "Grid":
        """Wait until the device has finished writing this grid."""
        device = self.device
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return self

    def __repr__(self) -> str:
        h, w = self.shape
        n = len(cell_leaves(self.arrays))
        return f"Grid({h}x{w}, {n} field{'s' if n != 1 else ''}, {self.device})"
