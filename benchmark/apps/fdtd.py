"""FDTD's inputs from the seed, and the port's updater that runs them as a
user's snapshot loop does.

The state the benchmark keeps is the port's coefficient cell (``ex, ey, hz,
hz_sum, ca, cb, da, db``) and an ``iteration`` plane: every cell holds the
absolute iteration the grid's next call starts at. The plane never enters
the port: :class:`CavityGrid` carries the offset beside the port's grid,
and :func:`from_grid` makes the plane from it.
"""

from __future__ import annotations

import copy
import json
from pathlib import Path

import torch

from stencilstream_tpu_torch import Grid
from stencilstream_tpu_torch.models import fdtd

CONFIG = Path(__file__).resolve().parents[1] / "configs" / "fdtd.json"
FIELDS = ("ex", "ey", "hz", "hz_sum", "ca", "cb", "da", "db")


class CavityGrid(Grid):
    """The port's grid of coefficient cells and the absolute iteration its
    next call starts at (the snapshot loop's ``iteration_offset``)."""

    __slots__ = ("offset",)

    def __init__(self, arrays, offset: int):
        super().__init__(arrays)
        self.offset = int(offset)


def parameters(config: dict, height: int, width: int) -> fdtd.Parameters:
    """The configuration's experiment with its ring sized by the grid-scaling
    rule, ``(side - 2.5) / 2 * dx``, for the shorter side of the grid."""
    experiment = copy.deepcopy(config["experiment"])
    side = min(height, width)
    experiment["cavity_rings"][0]["radius"] = (side - 2.5) / 2 * experiment["dx"]
    p = fdtd.Parameters.from_json(experiment)
    if p.grid_range() != (side, side):
        raise ValueError(f"the ring rule gives a {p.grid_range()} grid, not {side}^2")
    return p


def make_inputs(height: int, width: int, seed: int, device) -> dict[str, torch.Tensor]:
    """The coefficients of the published geometry (the port's own
    initialisation, in the top-left square of a grid that is not square),
    ``ex, ey, hz`` U(-1, 1) drawn on ``device`` by one generator seeded with
    ``seed``, ``hz_sum`` 0 and the iteration offset 0. The reference does not
    read these coefficient planes: it derives its own, and compares them."""
    p = parameters(json.loads(CONFIG.read_text()), height, width)
    side = min(height, width)
    square = fdtd.init_grid(p, fdtd.CoefResolver(p), device=device).arrays
    gen = torch.Generator(device=device).manual_seed(seed % 2**64)
    fields = {}
    for name in FIELDS:
        if name in ("ex", "ey", "hz"):
            fields[name] = torch.rand(height, width, generator=gen, device=device).mul_(2.0).sub_(1.0)
        else:
            fields[name] = torch.zeros(height, width, device=device)
            fields[name][:side, :side] = getattr(square, name)
    fields["iteration"] = torch.zeros(height, width, device=device)
    return fields


def to_grid(fields: dict[str, torch.Tensor]) -> CavityGrid:
    cell = fdtd.CoefResolver.MaterialCell(**{name: fields[name] for name in FIELDS})
    return CavityGrid(cell, int(fields["iteration"].reshape(-1)[0]))


def from_grid(grid: CavityGrid) -> dict[str, torch.Tensor]:
    """The port grid's own tensors, ``ex`` first, and the offset's plane."""
    fields = {name: getattr(grid.arrays, name) for name in FIELDS}
    fields["iteration"] = torch.full_like(fields["ex"], float(grid.offset))
    return fields


def make_update(config: dict, traffic: dict):
    """The updater of a snapshot loop (``models/fdtd/__init__.py:run``): one
    coefficient-resolver simulation of ``n_iterations`` a call, whose
    ``iteration_offset`` is set to the input grid's before each call."""
    n = traffic["n_iterations"]
    p = parameters(config, traffic["height"], traffic["width"])
    update, _ = fdtd.build_simulation(
        p, fdtd.RESOLVERS[config["resolver"]](p),
        backend=traffic["backend"], tdv_strategy=config["tdv_strategy"], n_iterations=n, **traffic["options"],
    )
    params = update.get_params()

    def call(grid: CavityGrid) -> CavityGrid:
        params.iteration_offset = grid.offset
        return CavityGrid(update(grid).arrays, grid.offset + n)

    return call
