"""Jacobi5General on a grid held in row slabs over the cell's cards: the
inputs drawn block by block on each block's card from the seed, and the
port's ``distributed`` updater, which keeps every block on its card from
call to call (``BlockGrid``, imported here, so that a port without it fails
at once)."""

from __future__ import annotations

import torch

from stencilstream_tpu_torch import BlockGrid, Params, create_update
from stencilstream_tpu_torch.backends.distributed import framed_empty
from stencilstream_tpu_torch.models import jacobi
from stencilstream_tpu_torch.parallel import make_mesh

#: The config file's coefficient names in the order ``make_kernel`` takes them.
ORDER = ("up", "left", "down", "right", "center")
#: Rows of frame around each block, as a user who keeps the grid resident
#: allocates it: the stored halo of the tile law's pass for this cell (r p k =
#: 8 at p = 8), so that the first call reads the blocks in place as every
#: later one does.
FRAME_ROWS = 8


def make_block_inputs(height: int, width: int, seed: int, rows: range, cols: range, device) -> dict:
    """U(0.5, 1.5) in every cell of the block at ``rows x cols``, drawn on
    ``device`` by a generator seeded with ``seed`` and the block's first row
    and column, into the core of a buffer framed for the port
    (``framed_empty``)."""
    gen = torch.Generator(device=device).manual_seed(((seed * 1_000_003 + rows.start) * 1_000_003 + cols.start) % 2**64)
    value = framed_empty((len(rows), len(cols)), dtype=torch.float32, device=device, frame=FRAME_ROWS)
    torch.rand(len(rows), len(cols), generator=gen, device=device, out=value)
    return {"value": value.add_(0.5)}


def make_inputs(height: int, width: int, seed: int, device) -> dict:
    """The inputs of a grid of one block."""
    return make_block_inputs(height, width, seed, range(height), range(width), device)


def to_grid(blocks: dict) -> BlockGrid:
    """The blocks ``{(iy, ix): {"value": tensor}}`` as the port's grid, no copy."""
    ny, nx = (max(k[i] for k in blocks) + 1 for i in (0, 1))
    return BlockGrid([[blocks[iy, ix]["value"] for ix in range(nx)] for iy in range(ny)])


def from_grid(grid: BlockGrid, layout) -> dict:
    """The grid's blocks as ``{(iy, ix): {"value": tensor}}``, views, each on its card."""
    out = {}
    for (iy, ix), (rows, cols, device) in layout.blocks.items():
        t = grid.blocks[iy][ix]
        if tuple(t.shape) != (len(rows), len(cols)) or t.device != torch.device(device):
            raise ValueError(f"block {(iy, ix)} is {tuple(t.shape)} on {t.device}, the layout's "
                             f"{(len(rows), len(cols))} on {device}")
        out[iy, ix] = {"value": t}
    return out


def make_update(config: dict, traffic: dict):
    """The updater a Jacobi user with a grid in blocks builds:
    ``jacobi5_general`` with the config's coefficients, halo 0.0,
    ``n_iterations`` a blocking call, on ``distributed`` over a mesh of the
    traffic's shape (the visible cards, or the CPU repeated where there is
    none), p and the tile as the tile law picks them for a block."""
    shape = tuple(traffic["mesh"])
    n = shape[0] * shape[1]
    mesh = make_mesh(shape=shape) if torch.cuda.is_available() else make_mesh(shape=shape, devices=["cpu"] * n)
    coefs = [config["coefficients"][k] for k in ORDER]
    params = Params(
        transition_function=jacobi.make_kernel("jacobi5_general", coefs),
        halo_value=config["halo_value"]["value"],
        n_iterations=traffic["n_iterations"],
        blocking=True,
    )
    return create_update(params, backend="distributed", mesh=mesh, **{"iters_per_pass": None, **traffic["options"]})
