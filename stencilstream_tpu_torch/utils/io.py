"""Host-side float-grid I/O used by the HotSpot application.

Counterpart of the HotSpot readers and writers of
``stencilstream_tpu/utils/io.py``, in numpy: whitespace-separated text and
raw float32 binary grids, and the ``<flat index>\\t<value>`` text output.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "read_float_grid_text",
    "read_float_grid_binary",
    "write_float_grid_binary",
    "write_indexed_text",
]


def read_float_grid_text(path: str, height: int, width: int) -> np.ndarray:
    with open(path) as f:
        vals = np.array(f.read().split()[: height * width], dtype=np.float32)
    if vals.size != height * width:
        raise ValueError(f"{path}: expected {height * width} values, got {vals.size}")
    return vals.reshape(height, width)


def read_float_grid_binary(path: str, height: int, width: int) -> np.ndarray:
    vals = np.fromfile(path, dtype=np.float32, count=height * width)
    if vals.size != height * width:
        raise ValueError(f"{path}: expected {height * width} float32s, got {vals.size}")
    return vals.reshape(height, width)


def write_float_grid_binary(path: str, grid: np.ndarray) -> None:
    np.asarray(grid, dtype=np.float32).tofile(path)


def write_indexed_text(path: str, grid: np.ndarray) -> None:
    """HotSpot text output: ``<flat index>\\t<value>`` per line."""
    flat = np.asarray(grid, dtype=np.float32).ravel()
    with open(path, "w") as f:
        for i, v in enumerate(flat):
            f.write(f"{i}\t{v:g}\n")
