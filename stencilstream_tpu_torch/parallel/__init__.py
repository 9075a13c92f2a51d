"""Device meshes and the halo exchange between their positions.

Counterpart of ``stencilstream_tpu/parallel/__init__.py``. The JAX package
runs one program over a ``jax.sharding.Mesh`` (``shard_map``) and moves
boundary strips with ``lax.ppermute``; the port is single-controller too:
one process holds a :class:`Mesh` of ``torch.device``s, a sharded grid is
one block per mesh position (a nested list of cells, each on its
position's device), and a shift between positions is a slice copied to
the receiving position's device (a peer copy between two cards, nothing
on one card). A mesh may name one device several times, so the exchange
and the multi-device backends run on one card, or on the CPU, as they
would across cards.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import numpy as np
import torch

from ..core.cell import cell_leaves, cell_map

__all__ = [
    "Mesh",
    "make_mesh",
    "mesh_factor",
    "exchange_frames",
    "exchange_halo",
    "exchange_halo_rows",
]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """An array of ``torch.device``s, one per mesh position: ``(ny, nx)``
    for a mesh that shards rows and columns, ``(n,)`` for the ring
    backend's 1D mesh."""

    devices: np.ndarray

    @property
    def shape(self) -> tuple[int, ...]:
        return self.devices.shape

    @property
    def size(self) -> int:
        return self.devices.size

    def device_set(self) -> list[torch.device]:
        """Each distinct device of the mesh once, in mesh order."""
        seen = []
        for d in self.devices.flat:
            if d not in seen:
                seen.append(d)
        return seen


def mesh_factor(n: int) -> tuple[int, int]:
    """Factor ``n`` devices into a near-square ``(ny, nx)`` grid (ny <= nx)."""
    best = (1, n)
    for ny in range(1, int(math.isqrt(n)) + 1):
        if n % ny == 0:
            best = (ny, n // ny)
    return best


def make_mesh(
    n_devices: int | None = None,
    shape: Sequence[int] | None = None,
    devices: Sequence[Any] | None = None,
) -> Mesh:
    """A mesh of ``devices`` (default: every visible CUDA device; raises
    when there is none). ``shape`` is ``(ny, nx)`` (default:
    :func:`mesh_factor` of ``n_devices``) or ``(n,)`` for a ring.
    ``devices`` may repeat a device, and the mesh takes its first
    ``prod(shape)`` entries."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is visible; pass devices= (CPU devices included)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices) if shape is None else math.prod(shape)
    if shape is None:
        shape = mesh_factor(n_devices)
    shape = tuple(int(s) for s in shape)
    if math.prod(shape) != n_devices:
        raise ValueError(f"a mesh of shape {shape} does not hold {n_devices} devices")
    if n_devices > len(devices):
        raise ValueError(f"requested {n_devices} devices but only {len(devices)} available")
    grid = np.empty(n_devices, dtype=object)
    grid[:] = devices[:n_devices]
    return Mesh(grid.reshape(shape))


def _framed(block: Any, halo_r: int, halo_c: int) -> Any:
    """Each field of ``block`` in a new buffer with ``halo_r`` rows and
    ``halo_c`` columns on every side: the core copied in, the frame left for
    the exchange to write."""

    def frame(a):
        h, w = a.shape
        out = torch.empty((h + 2 * halo_r, w + 2 * halo_c), dtype=a.dtype, device=a.device)
        out[halo_r : halo_r + h, halo_c : halo_c + w] = a
        return out

    return cell_map(frame, block)


def _fill_axis(line: Sequence[Any], axis: int, halo: int, across: int) -> tuple[int, int]:
    """One phase of the exchange along one line of mesh positions: write
    into the two ``halo``-wide frame strips of each framed block ``line[i]``
    along ``axis`` the boundary strips of its neighbours' cores, read from
    their framed blocks (each with ``across`` frame cells on either side of
    the other axis), copied to its device, and zeros at the line's ends. Row
    strips span the core's columns, column strips every row, so that the
    column phase carries the corners. Returns the strips copied from a
    neighbour and their bytes."""
    strips = nbytes = 0
    if not halo:
        return strips, nbytes
    for i, e in enumerate(line):
        for j, dst in enumerate(cell_leaves(e)):
            n = dst.shape[axis]
            for side, k in ((slice(0, halo), i - 1), (slice(n - halo, n), i + 1)):
                strip = dst[side, across : dst.shape[1] - across] if axis == 0 else dst[:, side]
                if not 0 <= k < len(line):
                    strip.zero_()
                    continue
                src = cell_leaves(line[k])[j]
                m = src.shape[axis]
                # the neighbour's core strip beside its own frame
                cut = slice(m - 2 * halo, m - halo) if k < i else slice(halo, 2 * halo)
                strip.copy_(src[cut, across : src.shape[1] - across] if axis == 0 else src[:, cut])
                strips += 1
                nbytes += strip.numel() * strip.element_size()
    return strips, nbytes


def exchange_frames(framed: Sequence[Sequence[Any]], halo: tuple[int, int]) -> tuple[int, int]:
    """Fill the frames of framed blocks in place from their mesh neighbours.

    ``framed[iy][ix]`` is the cell at mesh position ``(iy, ix)``, each field
    a buffer of its core with ``halo = (rows, cols)`` frame cells on every
    side, on that position's device. Each frame strip takes the neighbour's
    boundary strip of the same width from the neighbour's core; rows move
    first and columns after, the columns taken over every row of the
    row-filled blocks, so corners arrive from the diagonal neighbours.
    Mesh-edge frames receive zeros (callers mask them against the grid's
    bounds). Only the strips move, each one copy to the receiving
    position's device: a peer copy between two cards, which PyTorch orders
    after the work queued on both cards' current streams by CUDA events and
    before any work queued there later, so no host synchronize is needed.
    Returns the strips copied from a neighbour and their bytes."""
    ny, nx = len(framed), len(framed[0])
    halo_r, halo_c = halo
    rows = [_fill_axis([framed[iy][ix] for iy in range(ny)], 0, halo_r, halo_c) for ix in range(nx)]
    cols = [_fill_axis(framed[iy], 1, halo_c, 0) for iy in range(ny)]
    return sum(s for s, _ in rows + cols), sum(b for _, b in rows + cols)


def exchange_halo_rows(blocks: Sequence[Any], halo: int) -> list[Any]:
    """Row-only halo exchange along one mesh axis: extend each rank's block
    of ``(h, w)`` fields to ``(h + 2*halo, w)`` with its neighbours' boundary
    rows; ranks at the axis's ends receive zeros there. The row phase of
    :func:`exchange_halo`."""
    ext = [_framed(b, halo, 0) for b in blocks]
    _fill_axis(ext, 0, halo, 0)
    return ext


def exchange_halo(blocks: Sequence[Sequence[Any]], halo: int | tuple[int, int], mesh: Mesh) -> list[list[Any]]:
    """Extend each block of a 2D mesh with halo rows and columns from its
    mesh neighbours.

    ``blocks[iy][ix]`` is the cell of ``(h, w)`` fields at mesh position
    ``(iy, ix)``, on that position's device; the result holds
    ``(h + 2*halo_rows, w + 2*halo_cols)`` fields there, ``halo`` one int for
    both axes or a ``(rows, cols)`` pair. Each extended field is one new
    buffer, the core copied in once and each frame strip written once by
    :func:`exchange_frames` (the JAX package's lane packing has no
    counterpart: a copy of a strided slice moves only its bytes).
    """
    halo = halo if isinstance(halo, tuple) else (halo, halo)
    ext = [[_framed(b, *halo) for b in row] for row in blocks]
    exchange_frames(ext, halo)
    return ext
