"""HotSpot as the app of a cell in blocks, for the benchmark's tests and for
a run on several cards (``sharded_run.py``); no cell of ``BENCHMARK.json``
uses it.

Each block's inputs are drawn on its card. ``to_grid`` gathers the blocks
into one grid on the first block's device, the port's ``distributed``
backend shards it again over a mesh of the traffic's shape (the visible
cards, or the CPU repeated where there is none) and brings the output back
there, and ``from_grid`` cuts it into the layout's blocks, each on its
card.
"""

from __future__ import annotations

import torch

from stencilstream_tpu_torch import Grid, Params, create_update
from stencilstream_tpu_torch.models import hotspot
from stencilstream_tpu_torch.parallel import make_mesh


def make_block_inputs(height: int, width: int, seed: int, rows: range, cols: range, device) -> dict:
    """temp U(70, 90) and power U(0, 1e-3) of the block at ``rows x cols``,
    drawn on ``device`` by a generator seeded with ``seed`` and the block's
    first row and column."""
    gen = torch.Generator(device=device).manual_seed(((seed * 1_000_003 + rows.start) * 1_000_003 + cols.start) % 2**64)
    temp = torch.rand(len(rows), len(cols), generator=gen, device=device).mul_(20.0).add_(70.0)
    power = torch.rand(len(rows), len(cols), generator=gen, device=device).mul_(1e-3)
    return {"temp": temp, "power": power}


def gather(blocks: dict) -> dict[str, torch.Tensor]:
    """The whole grid's fields on the first block's device."""
    keys = sorted(blocks)
    device = blocks[keys[0]]["temp"].device
    out = {}
    for name in ("temp", "power"):
        strips = [torch.cat([blocks[k][name].to(device) for k in keys if k[0] == iy], dim=1)
                  for iy in sorted({k[0] for k in keys})]
        out[name] = torch.cat(strips, dim=0)
    return out


def to_grid(blocks: dict) -> Grid:
    return Grid(hotspot.HotspotCell(**gather(blocks)))


def from_grid(grid: Grid, layout) -> dict:
    arrays = {"temp": grid.arrays.temp, "power": grid.arrays.power}
    return {key: {name: t[rows.start:rows.stop, cols.start:cols.stop].to(device) for name, t in arrays.items()}
            for key, (rows, cols, device) in layout.blocks.items()}


def make_update(config: dict, traffic: dict):
    """The port's HotSpot on ``distributed`` over a mesh of the traffic's
    shape; ``n_iterations`` a blocking call."""
    shape = tuple(traffic["mesh"])
    n = shape[0] * shape[1]
    mesh = make_mesh(shape=shape) if torch.cuda.is_available() else make_mesh(shape=shape, devices=["cpu"] * n)
    params = Params(
        transition_function=hotspot.derive_coefficients(traffic["height"], traffic["width"]),
        halo_value=hotspot.HotspotCell(**config["halo_value"]),
        n_iterations=traffic["n_iterations"],
        blocking=True,
    )
    return create_update(params, backend="distributed", mesh=mesh, **traffic["options"])
