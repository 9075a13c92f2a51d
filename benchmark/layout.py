"""A cell's grid in blocks over its cards.

A traffic file may carry ``"mesh": [ny, nx]``, with ``ny * nx`` the cell's
``chips``; without it the mesh is ``[1, 1]``. Block ``(iy, ix)`` covers rows
``[iy h, min((iy + 1) h, H))`` with ``h = ceil(H / ny)``, and the columns
alike, and lives on card ``iy nx + ix``. The harness keeps every grid as
``{(iy, ix): {field: tensor}}``; a cell of one block holds the whole grid
on one device, as an app's ``make_inputs`` makes it.

An app that serves a mesh of more than one block gives
``make_block_inputs(H, W, seed, rows, cols, device)`` (``rows`` and
``cols`` are ``range``s), ``to_grid(blocks)`` and ``from_grid(grid,
layout)``, which returns the blocks, each on its card.
"""

from __future__ import annotations

import torch

__all__ = ["Layout", "mesh_of"]


def mesh_of(traffic: dict, chips: int) -> tuple[int, int]:
    """The traffic's ``(ny, nx)``; refuses a mesh that is not two positive
    whole numbers whose product is ``chips``."""
    mesh = traffic.get("mesh", [1, 1])
    if (not isinstance(mesh, list) or len(mesh) != 2
            or not all(isinstance(m, int) and not isinstance(m, bool) and m > 0 for m in mesh)):
        raise ValueError(f"a traffic's mesh is [ny, nx], two positive whole numbers (got {mesh!r})")
    if mesh[0] * mesh[1] != chips:
        raise ValueError(f"the mesh {mesh} holds {mesh[0] * mesh[1]} blocks, but the cell has {chips} chip(s)")
    return mesh[0], mesh[1]


class Layout:
    """The blocks of an ``H x W`` grid on an ``(ny, nx)`` mesh: ``blocks``
    maps ``(iy, ix)`` to ``(rows, cols, device)``, in card order.
    ``devices`` holds one device a block, in card order."""

    def __init__(self, height: int, width: int, mesh: tuple[int, int], devices: list):
        ny, nx = mesh
        if len(devices) != ny * nx:
            raise ValueError(f"a mesh of {ny * nx} blocks needs as many devices (got {len(devices)})")
        h, w = -(-height // ny), -(-width // nx)
        self.height, self.width, self.mesh = height, width, (ny, nx)
        self.blocks = {}
        for iy in range(ny):
            for ix in range(nx):
                rows = range(iy * h, min((iy + 1) * h, height))
                cols = range(ix * w, min((ix + 1) * w, width))
                if not rows or not cols:
                    raise ValueError(f"the mesh {[ny, nx]} leaves block {(iy, ix)} of a {height} x {width} grid empty")
                self.blocks[(iy, ix)] = (rows, cols, devices[iy * nx + ix])

    @property
    def whole(self) -> bool:
        """One block: the whole grid on one device."""
        return len(self.blocks) == 1

    def devices(self) -> list:
        """Each distinct device of the blocks once, in card order."""
        out = []
        for _, _, device in self.blocks.values():
            if device not in out:
                out.append(device)
        return out

    def gather(self, source, rows: range, cols: range, device) -> dict[str, torch.Tensor]:
        """The fields of ``rows x cols`` on ``device``, copied from the
        blocks it overlaps; ``source(key)`` gives a block's fields."""
        out = {}
        for key, (b_rows, b_cols, _) in self.blocks.items():
            r0, r1 = max(rows.start, b_rows.start), min(rows.stop, b_rows.stop)
            c0, c1 = max(cols.start, b_cols.start), min(cols.stop, b_cols.stop)
            if r0 >= r1 or c0 >= c1:
                continue
            fields = source(key)
            for name, t in fields.items():
                if name not in out:
                    out[name] = torch.empty(len(rows), len(cols), dtype=t.dtype, device=device)
                out[name][r0 - rows.start:r1 - rows.start, c0 - cols.start:c1 - cols.start].copy_(
                    t[r0 - b_rows.start:r1 - b_rows.start, c0 - b_cols.start:c1 - b_cols.start])
            del fields
        return out
