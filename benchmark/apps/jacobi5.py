"""Jacobi5General's inputs from the seed, and the port's updater that runs them."""

from __future__ import annotations

import math

import torch

from stencilstream_tpu_torch import Grid, Params, create_update
from stencilstream_tpu_torch.models import jacobi

#: The config file's coefficient names in the order ``make_kernel`` takes them.
ORDER = ("up", "left", "down", "right", "center")


def make_inputs(height: int, width: int, seed: int, device) -> dict[str, torch.Tensor]:
    """The centred half-size block (rows and columns from a quarter to three
    quarters of the grid) holds U(0.5, 1.5), drawn on ``device`` by one
    generator seeded with ``seed``; every other cell is 0.0."""
    gen = torch.Generator(device=device).manual_seed(seed % 2**64)
    value = torch.rand(height, width, generator=gen, device=device).add_(0.5)
    r0, r1 = math.ceil(height * 0.25), math.ceil(height * 0.75)
    c0, c1 = math.ceil(width * 0.25), math.ceil(width * 0.75)
    value[:r0] = 0.0
    value[r1:] = 0.0
    value[:, :c0] = 0.0
    value[:, c1:] = 0.0
    return {"value": value}


def to_grid(fields: dict[str, torch.Tensor]) -> Grid:
    return Grid(fields["value"])


def from_grid(grid: Grid) -> dict[str, torch.Tensor]:
    return {"value": grid.arrays}


def make_update(config: dict, traffic: dict):
    """The updater a Jacobi user builds: ``jacobi5_general`` with the
    config's coefficients, halo 0.0, ``n_iterations`` a blocking call."""
    coefs = [config["coefficients"][k] for k in ORDER]
    params = Params(
        transition_function=jacobi.make_kernel("jacobi5_general", coefs),
        halo_value=config["halo_value"]["value"],
        n_iterations=traffic["n_iterations"],
        blocking=True,
    )
    return create_update(params, backend=traffic["backend"], **traffic["options"])
