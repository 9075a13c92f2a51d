"""HotSpot's inputs from the seed, and the port's updater that runs them."""

from __future__ import annotations

import torch

from stencilstream_tpu_torch import Grid, Params, create_update
from stencilstream_tpu_torch.models import hotspot


def make_inputs(height: int, width: int, seed: int, device) -> dict[str, torch.Tensor]:
    """temp U(70, 90) and power U(0, 1e-3) in float32, drawn on ``device``
    by one generator seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed % 2**64)
    temp = torch.rand(height, width, generator=gen, device=device).mul_(20.0).add_(70.0)
    power = torch.rand(height, width, generator=gen, device=device).mul_(1e-3)
    return {"temp": temp, "power": power}


def to_grid(fields: dict[str, torch.Tensor]) -> Grid:
    return Grid(hotspot.HotspotCell(temp=fields["temp"], power=fields["power"]))


def from_grid(grid: Grid) -> dict[str, torch.Tensor]:
    return {"temp": grid.arrays.temp, "power": grid.arrays.power}


def make_update(config: dict, traffic: dict):
    """The updater a HotSpot user builds: the coefficients the port derives
    for the grid, clamped edges, ``n_iterations`` a blocking call."""
    tf = hotspot.derive_coefficients(traffic["height"], traffic["width"])
    params = Params(
        transition_function=tf,
        halo_value=hotspot.HotspotCell(**config["halo_value"]),
        n_iterations=traffic["n_iterations"],
        blocking=True,
    )
    return create_update(params, backend=traffic["backend"], **traffic["options"])
