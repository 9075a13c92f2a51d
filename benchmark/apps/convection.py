"""Thermal convection's inputs from the seed, and the port's updater: one
timestep of the convergence loop a call (``convection.Simulation.step``)."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from stencilstream_tpu_torch import Grid
from stencilstream_tpu_torch.models import convection

CONFIG = Path(__file__).resolve().parents[1] / "configs" / "convection.json"
FIELDS = convection.FIELDS
#: Half-widths of the seeded draws: the temperature's perturbation, in
#: units of ``deltaT``, and every other physics field's value.
T_NOISE = 1e-2
FIELD_NOISE = 1e-3


@dataclasses.dataclass
class GridExperiment(convection.Experiment):
    """The experiment on a ``height x width`` grid: ``nx = height - 1``,
    ``ny = width - 1``, ``dx`` and ``dy`` from ``lx`` and ``ly`` as
    upstream derives them. On the ``(3 res) x res`` grid of ``lx 3, ly 1``
    these are ``res``'s own."""

    height: int = 0
    width: int = 0

    @property
    def nx(self):
        return self.height - 1

    @property
    def ny(self):
        return self.width - 1


def experiment(config: dict, height: int, width: int) -> convection.Experiment:
    """The configuration's experiment on a ``height x width`` grid, one
    timestep a run (``res = width / ly``, which only the grid's size
    reads)."""
    return GridExperiment(**config["experiment"], res=round(width / config["experiment"]["ly"]), nt=1, nout=1,
                          height=height, width=width)


def make_inputs(height: int, width: int, seed: int, device) -> dict[str, torch.Tensor]:
    """``T``: upstream's initial condition (the blob and the two plates,
    ``convection.init_grid``) plus a perturbation U(-1, 1) ``T_NOISE
    deltaT`` in the active region between the plates; every other field
    U(-1, 1) ``FIELD_NOISE``; all float64, drawn on ``device`` by one
    generator seeded with ``seed``."""
    config = json.loads(CONFIG.read_text())
    e = experiment(config, height, width)
    gen = torch.Generator(device=device).manual_seed(seed % 2**64)

    def uniform(half_width):
        return torch.rand(height, width, generator=gen, device=device, dtype=torch.float64).sub_(0.5).mul_(2 * half_width)

    T = convection.init_grid(e, np.float64, device=device).arrays.T
    x = torch.arange(height, device=device)[:, None]
    y = torch.arange(width, device=device)[None, :]
    between = (x < e.nx) & (y > 0) & (y < e.ny - 1)
    fields = {"T": torch.where(between, T + uniform(T_NOISE * e.deltaT), T)}
    for name in FIELDS[1:]:
        fields[name] = uniform(FIELD_NOISE)
    return fields


def to_grid(fields: dict[str, torch.Tensor]) -> Grid:
    return Grid(convection.ThermalConvectionCell(**{name: fields[name] for name in FIELDS}))


def from_grid(grid: Grid) -> dict[str, torch.Tensor]:
    return {name: getattr(grid.arrays, name) for name in FIELDS}


def make_update(config: dict, traffic: dict, dtype=None):
    """One timestep a call, through a :class:`convection.Simulation` made
    once (``dtype`` the configuration's unless given). A call runs
    ``n_iterations`` pseudo-transient iterations: ``iterMax``, or, where
    ``n_iterations`` is less, a timestep capped at it (``iterMax =
    n_iterations`` and ``nerr`` at most that), as the reference runs it.
    They are counted by ``convection.pt_iterations``: a timestep that
    converged before raises, since the benchmark counts ``H W n`` cells a
    call."""
    e = experiment(config, traffic["height"], traffic["width"])
    n = traffic["n_iterations"]
    if n > e.iterMax:
        raise ValueError(f"a call is one timestep: n_iterations {n} must be at most the experiment's iterMax {e.iterMax}")
    e = dataclasses.replace(e, iterMax=n, nerr=min(e.nerr, n))
    sim = convection.Simulation(e, dtype or getattr(np, config["dtype"]), False, traffic["backend"],
                                **traffic["options"])

    def call(grid: Grid) -> Grid:
        before = convection.pt_iterations
        out = sim.step(grid)
        ran = convection.pt_iterations - before
        if ran != n:
            s = sim.stats
            raise RuntimeError(f"the timestep ran {ran} pseudo-transient iterations, not {n}: errV {s['errV']:.3e} "
                               f"and errP {s['errP']:.3e} reached epsilon {e.epsilon:g} before iterMax")
        return out

    return call


def precision_below(config: dict, traffic: dict):
    """The port's own float32 path, the precision below the configuration's
    float64, in the program's place: each call casts the grid to float32,
    runs one float32 timestep and casts back (a ``wrap`` for
    ``benchmark.run.run_cell``)."""

    def wrap(update, app):
        step = make_update(config, traffic, np.float32)

        def call(grid: Grid) -> Grid:
            fields = from_grid(grid)
            out = from_grid(step(to_grid({k: v.to(torch.float32) for k, v in fields.items()})))
            return to_grid({k: v.to(fields[k].dtype) for k, v in out.items()})

        return call

    return wrap
