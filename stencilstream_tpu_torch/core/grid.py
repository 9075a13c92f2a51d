"""The Grid: a 2D field of cells, stored struct-of-arrays.

Counterpart of ``stencilstream_tpu/core/grid.py``: a cell of ``(H, W)``
tensors, one per field, all on one device. Every constructor takes the
device explicitly. A :class:`BlockGrid` holds the cells in blocks over a
mesh of devices instead, for the ``distributed`` backend.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .cell import (
    NARROW_DTYPES, cell_block_shape, cell_field_names, cell_full_grid, cell_leaves, cell_map, cell_unflatten,
    cell_zeros,
)

__all__ = ["BlockGrid", "Grid", "synchronize"]

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

    def cells(self) -> list:
        """The cells of tensors the grid holds: its ``arrays``, or one a block."""
        return [self.arrays]

    def __repr__(self) -> str:
        h, w = self.shape
        n = len(cell_leaves(self.arrays))
        return f"Grid({h}x{w}, {n} field{'s' if n != 1 else ''}, {self.device})"


class BlockGrid(Grid):
    """A 2D grid of cells held in blocks over a mesh of devices: ``blocks[iy][ix]``
    is the cell of ``(h_iy, w_ix)`` tensors at mesh position ``(iy, ix)``, all
    on that position's device. The blocks of a mesh row share their height,
    those of a mesh column their width, and every block has the cell's
    fields and dtypes. The ``distributed`` backend takes one and returns one
    on the same devices, the blocks staying on their devices from call to
    call (no other backend takes it).

    ``BlockGrid(blocks)`` holds the given tensors, no copy; ``blocks`` gives
    them back (a result's are views of the backend's buffers: a block of a
    mesh that also splits columns is not contiguous). :meth:`shard` cuts a
    :class:`Grid` into blocks (copies) and :meth:`gather` joins them into
    one :class:`Grid`. ``arrays`` raises, and so does every :class:`Grid`
    method that reads it (``cell_at``, ``set_cell``, ``make_similar``): the
    cells are the blocks'.
    """

    __slots__ = ("blocks",)

    def __init__(self, blocks: Any):
        rows = tuple(tuple(row) for row in blocks)
        if not rows or not rows[0] or any(len(row) != len(rows[0]) for row in rows):
            raise ValueError("a BlockGrid takes a non-empty rectangular nested list of blocks, one list a mesh row")
        first = rows[0][0]
        names, dtypes = cell_field_names(first), [t.dtype for t in cell_leaves(first)]
        for iy, row in enumerate(rows):
            for ix, cell in enumerate(row):
                leaves = cell_leaves(cell)
                if cell_field_names(cell) != names or [t.dtype for t in leaves] != dtypes:
                    raise TypeError(f"block {(iy, ix)}'s fields differ from block (0, 0)'s in name or dtype")
                h, w = cell_block_shape(cell)
                if h != cell_block_shape(row[0])[0] or w != cell_block_shape(rows[0][ix])[1]:
                    raise ValueError(f"block {(iy, ix)} is {h}x{w}: the blocks of a mesh row share their height, "
                                     "those of a mesh column their width")
                if len({t.device for t in leaves}) != 1:
                    raise ValueError(f"block {(iy, ix)}'s fields lie on more than one device")
        self.blocks = rows

    @classmethod
    def shard(cls, grid: Grid, devices: Any) -> "BlockGrid":
        """``grid`` cut into ``ceil(H / ny) x ceil(W / nx)`` blocks (the last
        row and column of blocks shorter), block ``(iy, ix)`` copied to
        ``devices[iy][ix]`` (a nested list or a mesh's ``devices`` array)."""
        devices = np.asarray(devices, dtype=object)
        ny, nx = devices.shape
        H, W = grid.shape
        h, w = -(-H // ny), -(-W // nx)
        if (ny - 1) * h >= H or (nx - 1) * w >= W:
            raise ValueError(f"a {H}x{W} grid leaves blocks of a ({ny}, {nx}) mesh empty")
        return cls([[cell_map(lambda a: a[iy * h:(iy + 1) * h, ix * w:(ix + 1) * w].to(devices[iy, ix], copy=True),
                              grid.arrays) for ix in range(nx)] for iy in range(ny)])

    def gather(self, device=None) -> Grid:
        """The whole grid on ``device`` (default: block (0, 0)'s), a copy."""
        device = self.device if device is None else device
        leaves = [[cell_leaves(b) for b in row] for row in self.blocks]
        fields = [torch.cat([torch.cat([b[j].to(device) for b in row], dim=1) for row in leaves], dim=0)
                  for j in range(len(leaves[0][0]))]
        return Grid(cell_unflatten(self.blocks[0][0], fields))

    @property
    def arrays(self) -> Any:
        raise TypeError("a BlockGrid holds its cells in blocks over a mesh (.blocks), which only the 'distributed' "
                        "backend takes; .gather() gives one Grid")

    @property
    def mesh_shape(self) -> tuple[int, int]:
        return len(self.blocks), len(self.blocks[0])

    @property
    def devices(self) -> np.ndarray:
        """The blocks' devices, an ``(ny, nx)`` array."""
        out = np.empty(self.mesh_shape, dtype=object)
        for iy, row in enumerate(self.blocks):
            for ix, cell in enumerate(row):
                out[iy, ix] = cell_leaves(cell)[0].device
        return out

    def cells(self) -> list:
        return [cell for row in self.blocks for cell in row]

    @property
    def shape(self) -> tuple[int, int]:
        return (sum(cell_block_shape(row[0])[0] for row in self.blocks),
                sum(cell_block_shape(cell)[1] for cell in self.blocks[0]))

    @property
    def device(self) -> torch.device:
        """Block (0, 0)'s device; :attr:`devices` names every block's."""
        return cell_leaves(self.blocks[0][0])[0].device

    def to_numpy(self) -> Any:
        return self.gather().to_numpy()

    def block_until_ready(self) -> "BlockGrid":
        for device in dict.fromkeys(self.devices.flat):
            synchronize(device)
        return self

    def __repr__(self) -> str:
        (h, w), (ny, nx) = self.shape, self.mesh_shape
        n = len(cell_leaves(self.blocks[0][0]))
        return f"BlockGrid({h}x{w} in {ny}x{nx} blocks, {n} field{'s' if n != 1 else ''})"


def synchronize(device: torch.device) -> None:
    """Wait until ``device`` has finished its queued work (a CPU device has
    none)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
