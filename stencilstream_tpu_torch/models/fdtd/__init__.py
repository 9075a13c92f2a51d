"""FDTD — nano-photonic disk-cavity simulation, on the PyTorch/CUDA port.

Counterpart of ``stencilstream_tpu/models/fdtd/``: JSON experiment configs,
three material-resolver policies, a source wave delivered as the
time-dependent value (TDV), E/H sub-iterations, and a snapshot loop that
pauses and resumes through ``iteration_offset``.

On the card every resolver runs on the CUDA kernels through its device
functor (``csrc/ops/fdtd.cuh``), which reads the call's TDV stream; on CPU
tensors the kernels' plain PyTorch versions run. Run it on the card::

    python -m stencilstream_tpu_torch.models.fdtd -c experiment.json -o out/
"""

from __future__ import annotations

import argparse
import copy
import os
import sys

import numpy as np
import torch

from ...backends import create_update
from ...core import Grid, Params
from ...core.cell import cell_field_names
from ...utils.io import write_csv_frame
from .kernel import FDTDKernel, make_kernel
from .materials import RESOLVERS, CoefResolver, LUTResolver, RenderResolver
from .params import Parameters

__all__ = [
    "Parameters",
    "FDTDKernel",
    "make_kernel",
    "CoefResolver",
    "LUTResolver",
    "RenderResolver",
    "RESOLVERS",
    "MONO_BENCHMARK",
    "CUT_TIME",
    "mono_benchmark",
    "init_grid",
    "build_simulation",
    "run",
    "save_frame",
    "main",
]


#: The reference's mono-benchmark experiment, which the JAX package's bench
#: runs (``bench.py:280-306``): 1024^2 cells of 1.566 nm, one ring of 800 nm
#: (mu_r 11.56), a point source at the centre, 15 tau.
MONO_BENCHMARK = {
    "tau": 100e-15,
    "dx": 1.5655577299412914e-9,
    "time": {"t_cutoff": 7.0, "t_detect": 14.0, "t_max": 15.0},
    "source": {"frequency": 120e12, "phase": 3.0, "x": 0, "y": 0, "radius": 0},
    "cavity_rings": [{"radius": 800e-9, "mu_r": 11.56, "eps_r": 1.0, "sigma": 0.0}],
}
#: Its time axis cut (factors of tau) so that the pulse's peak, the cutoff,
#: the detection window and three snapshots fall within ~8.2k iterations
#: (one tau is ~27.4k iterations at this dx); the widths stay as published.
CUT_TIME = {"phase": 0.15, "t_cutoff": 0.2, "t_detect": 0.1, "t_max": 0.3, "t_snap": 0.1}


def mono_benchmark(side: int = 1024) -> dict:
    """The mono-benchmark experiment with its time axis cut
    (:data:`CUT_TIME`), on a ``side``^2 grid: the published ring at 1024,
    else a ring of the same cells whose radius gives ``side``."""
    config = copy.deepcopy(MONO_BENCHMARK)
    if side != 1024:
        config["cavity_rings"][0]["radius"] = (side - 2.5) / 2 * config["dx"]
    config["source"]["phase"] = CUT_TIME["phase"]
    config["time"] = {k: v for k, v in CUT_TIME.items() if k != "phase"}
    return config


def init_grid(parameters: Parameters, resolver, *, device="cuda") -> Grid:
    """Render the ring geometry into cells, on the card unless ``device``
    says otherwise."""
    h, w = parameters.grid_range()
    rr = np.arange(h, dtype=np.float32)[:, None] - np.float32(h) / 2.0
    cc = np.arange(w, dtype=np.float32)[None, :] - np.float32(w) / 2.0
    distance = parameters.dx * np.sqrt(rr * rr + cc * cc)

    ring_index = np.full((h, w), len(parameters.rings), np.int32)
    radius = 0.0
    assigned = np.zeros((h, w), bool)
    for i, ring in enumerate(parameters.rings):
        radius += ring.radius
        hit = (~assigned) & (distance < radius)
        ring_index[hit] = i
        assigned |= hit

    # Each field: the per-ring prototype cells' values, indexed by ring.
    prototypes = [resolver.cell_from_parameters(parameters, i) for i in range(len(parameters.rings) + 1)]
    fields = {
        name: np.asarray([getattr(p, name) for p in prototypes])[ring_index]
        for name in cell_field_names(prototypes[0])
    }
    return Grid.from_numpy(resolver.MaterialCell(**fields), device=device)


def build_simulation(
    parameters: Parameters,
    resolver=None,
    backend: str = "auto",
    tdv_strategy="inline",
    n_iterations: int | None = None,
    **backend_kwargs,
):
    """The updater of a whole run (``n_iterations`` defaults to the
    experiment's), and its resolver."""
    if resolver is None:
        resolver = CoefResolver(parameters)
    kernel = make_kernel(parameters, resolver)
    update = create_update(
        Params(
            transition_function=kernel,
            halo_value=resolver.halo_cell(),
            iteration_offset=0,
            n_iterations=parameters.n_timesteps() if n_iterations is None else n_iterations,
            blocking=True,
            tdv_strategy=tdv_strategy,
        ),
        backend=backend,
        **backend_kwargs,
    )
    return update, resolver


def save_frame(grid: Grid, iteration_index: int, field: str, parameters: Parameters) -> str:
    """Write one field of the grid as ``<field>.<iteration>.csv``."""
    path = os.path.join(parameters.out_dir, f"{field}.{iteration_index}.csv")
    write_csv_frame(path, getattr(grid.to_numpy(), field))
    return path


def run(
    parameters: Parameters,
    resolver=None,
    backend: str = "auto",
    tdv_strategy="inline",
    snapshots: bool = True,
    *,
    device="cuda",
    **backend_kwargs,
):
    """The full simulation, with the snapshot loop: with ``t_snap`` set, the
    run pauses every ``n_snap`` iterations, writes an ``hz`` frame and
    resumes through ``iteration_offset`` (overshooting the experiment's
    iterations to the next multiple of ``n_snap``, as the reference program
    does). Returns ``(grid, update)``."""
    update, resolver = build_simulation(
        parameters, resolver, backend=backend, tdv_strategy=tdv_strategy, **backend_kwargs
    )
    grid = init_grid(parameters, resolver, device=device)

    n_snap = parameters.n_snap_timesteps()
    if snapshots and n_snap is not None:
        p = update.get_params()
        p.n_iterations = n_snap
        while p.iteration_offset < parameters.n_timesteps():
            grid = update(grid)
            save_frame(grid, p.iteration_offset + n_snap, "hz", parameters)
            p.iteration_offset += n_snap
    else:
        grid = update(grid)
    return grid, update


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="fdtd", description="Nano-photonic disk cavity FDTD simulation")
    parser.add_argument("-c", dest="config", required=True, help="experiment JSON file ('-' for stdin)")
    parser.add_argument("-o", dest="out_dir", default=".")
    parser.add_argument("--material", default="coef", choices=sorted(RESOLVERS))
    parser.add_argument("--tdv", default="inline",
                        choices=["inline", "precompute_on_device", "precompute_on_host"])
    parser.add_argument("--backend", default="auto")
    parser.add_argument("--no-snapshots", action="store_true")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)

    parameters = Parameters.load(args.config, out_dir=args.out_dir)
    parameters.print_configuration()

    resolver = RESOLVERS[args.material](parameters)
    print("Simulating...")
    grid, update = run(
        parameters, resolver, backend=args.backend, tdv_strategy=args.tdv,
        snapshots=not args.no_snapshots, device=torch.device(args.device),
    )
    print("Simulation complete!")
    print(f"Walltime: {update.get_walltime()} s")
    save_frame(grid, parameters.n_timesteps(), "hz_sum", parameters)
    return 0
