"""Native host I/O: the file-format kernels of ``io_kernels.cpp``, bound with ctypes.

Counterpart of ``stencilstream_tpu/native``: Conway's character grids,
whitespace-separated floats, HotSpot's indexed text and CSV frames, parsed
and formatted in C++ (:mod:`..utils.io` dispatches here). The library is
compiled with ``g++`` at first use into the git-ignored
``stencilstream_tpu_torch/_build/``, its file name keyed by a hash of the
source and the flags, as the CUDA kernels are (``backends/cuda_lib.py``);
nothing is built into a package directory.

Only a machine without ``g++`` takes :mod:`..utils.io`'s Python path, and
:func:`available` says which path is in use. A compile that fails raises
``RuntimeError`` with the compiler's message; it is never swallowed.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

__all__ = [
    "available",
    "build",
    "parse_char_grid",
    "format_char_grid",
    "parse_floats",
    "format_indexed_text",
    "format_csv",
]

SOURCE = Path(__file__).resolve().parent / "io_kernels.cpp"
BUILD_DIR = SOURCE.parent.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()


def library_path() -> Path:
    """The library's path, keyed by a hash of the source and the flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libss_io_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the library unless the current source is already built.
    Returns ``(library path, seconds spent compiling)``, 0 seconds when it
    was there. Raises ``RuntimeError`` without ``g++`` or when the compile
    fails, with the compiler's message."""
    target = library_path()
    with _lock:
        if target.exists():
            return target, 0.0
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError("g++ not found: the native I/O library is built from source at first use")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        start = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
            tmp = Path(work) / target.name
            cmd = [cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
        return target, time.perf_counter() - start


def available() -> bool:
    """Whether the native path is in use: the library is built, or ``g++``
    is there to build it (which this call does, raising if it fails)."""
    if not library_path().exists() and shutil.which("g++") is None:
        return False
    _library()
    return True


@functools.cache
def _library() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    i64, c_char_p = ctypes.c_int64, ctypes.c_char_p
    u8_p, f32_p, f64_p = (ctypes.POINTER(t) for t in (ctypes.c_uint8, ctypes.c_float, ctypes.c_double))
    signatures = {
        "ss_parse_char_grid": [c_char_p, i64, i64, i64, u8_p],
        "ss_format_char_grid": [u8_p, i64, i64, c_char_p],
        "ss_parse_floats": [c_char_p, i64, i64, f32_p],
        "ss_format_indexed_text": [f32_p, i64, c_char_p],
        "ss_format_csv": [f32_p, i64, i64, c_char_p],
        "ss_format_csv_f64": [f64_p, i64, i64, c_char_p],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, i64
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def parse_char_grid(text: bytes, height: int, width: int) -> np.ndarray:
    """An ``X``/``.`` grid of ``height*width`` cells, whitespace skipped, as
    a bool array; ``ValueError`` naming the cell where it is truncated or
    holds another character."""
    out = np.empty(height * width, dtype=np.uint8)
    rc = _library().ss_parse_char_grid(text, len(text), height, width, _ptr(out, ctypes.c_uint8))
    if rc < 0:
        cells = height * width
        code = -rc - 1
        if code >= cells:
            cell = code - cells
            raise ValueError(f"unexpected character at cell ({cell // width}, {cell % width}); expected 'X' or '.'")
        raise ValueError(
            f"character grid truncated at cell ({code // width}, {code % width}); expected {height}x{width} cells"
        )
    return out.reshape(height, width).astype(bool)


def format_char_grid(grid: np.ndarray) -> bytes:
    """``X``/``.`` rows, each ending in a newline."""
    g = np.ascontiguousarray(grid, dtype=np.uint8)
    h, w = g.shape
    buf = ctypes.create_string_buffer(h * (w + 1))
    n = _library().ss_format_char_grid(_ptr(g, ctypes.c_uint8), h, w, buf)
    return buf.raw[:n]


def parse_floats(text: bytes, count: int) -> np.ndarray:
    """``count`` whitespace-separated floats as float32; ``ValueError`` if
    fewer parse."""
    out = np.empty(count, dtype=np.float32)
    # strtof may read one byte past the text: end it with a NUL.
    n = _library().ss_parse_floats(text + b"\0", len(text), count, _ptr(out, ctypes.c_float))
    if n != count:
        raise ValueError(f"expected {count} floats, parsed {n}")
    return out


def format_indexed_text(vals: np.ndarray) -> bytes:
    """``<flat index>\\t<%g value>`` lines of float32 values."""
    v = np.ascontiguousarray(vals, dtype=np.float32).ravel()
    buf = ctypes.create_string_buffer(v.size * 32)
    n = _library().ss_format_indexed_text(_ptr(v, ctypes.c_float), v.size, buf)
    return buf.raw[:n]


def format_csv(grid: np.ndarray) -> bytes:
    """Comma-separated ``%g`` rows of a 2D grid: float64 as it is, anything
    else as float32."""
    g = np.ascontiguousarray(grid)
    if g.dtype == np.float64:
        buf = ctypes.create_string_buffer(g.size * 24 + g.shape[0])
        n = _library().ss_format_csv_f64(_ptr(g, ctypes.c_double), g.shape[0], g.shape[1], buf)
    else:
        g = np.ascontiguousarray(g, dtype=np.float32)
        buf = ctypes.create_string_buffer(g.size * 16 + g.shape[0])
        n = _library().ss_format_csv(_ptr(g, ctypes.c_float), g.shape[0], g.shape[1], buf)
    return buf.raw[:n]
