"""Host-side grid I/O used by the applications.

Counterpart of ``stencilstream_tpu/utils/io.py``, in numpy: Conway's
``X``/``.`` character grids, whitespace-separated text and raw float32
binary grids, HotSpot's ``<flat index>\\t<value>`` text output, and FDTD's
comma-separated frames.
"""

from __future__ import annotations

from typing import IO

import numpy as np

__all__ = [
    "read_char_grid",
    "write_char_grid",
    "read_float_grid_text",
    "read_float_grid_binary",
    "write_float_grid_binary",
    "write_indexed_text",
    "write_csv_frame",
]


def read_char_grid(stream: IO[str], height: int, width: int) -> np.ndarray:
    """Read a ``height*width`` grid of ``X`` (alive) / ``.`` (dead)
    characters, skipping whitespace like ``std::cin >> char``."""
    out = np.empty((height, width), dtype=bool)
    chars = (ch for line in stream for ch in line if not ch.isspace())
    for r in range(height):
        for c in range(width):
            ch = next(chars, None)
            if ch is None:
                raise ValueError(
                    f"character grid truncated at cell ({r}, {c}); expected {height}x{width} cells"
                )
            if ch not in "X.":
                raise ValueError(f"unexpected character {ch!r} at cell ({r}, {c})")
            out[r, c] = ch == "X"
    return out


def write_char_grid(stream: IO[str], grid: np.ndarray) -> None:
    for row in np.asarray(grid, dtype=bool):
        stream.write("".join("X" if v else "." for v in row))
        stream.write("\n")


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


def write_csv_frame(path: str, grid: np.ndarray, fmt: str = "%g") -> None:
    """One field as comma-separated rows of ``fmt``-formatted values (FDTD's
    frames)."""
    np.savetxt(path, np.asarray(grid), fmt=fmt, delimiter=",")
