"""HotSpot — the Rodinia transient thermal simulation, on the PyTorch/CUDA port.

Counterpart of ``stencilstream_tpu/models/hotspot.py``: a two-field cell
(temperature + dissipated power), in-kernel boundary clamping via global
coordinates, the Rodinia update formula, text/binary file I/O, and the
``Walltime: X s`` / ``GFlops`` stdout protocol.

``HotspotKernel`` is both the plain PyTorch transition function and the name
of its device functor (``csrc/ops/hotspot.cuh``), which the CUDA kernels run
with the same four scalar parameters.

Run it on the card::

    python -m stencilstream_tpu_torch.models.hotspot 1024 1024 1000 temp.txt power.txt out.txt
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..backends import create_update
from ..core import Grid, Params, cell_type, transition_function
from ..core.fma import fma_f32
from ..utils.io import (
    read_float_grid_binary,
    read_float_grid_text,
    write_float_grid_binary,
    write_indexed_text,
)

__all__ = [
    "HotspotCell",
    "HotspotKernel",
    "derive_coefficients",
    "run",
    "main",
    "FLOPS_PER_CELL",
]

# Chip/physics constants (examples/hotspot/hotspot.cpp:40-55).
MAX_PD = 3.0e6
PRECISION = 0.001
SPEC_HEAT_SI = 1.75e6
K_SI = 100.0
FACTOR_CHIP = 0.5
T_CHIP = 0.0005
CHIP_HEIGHT = 0.016
CHIP_WIDTH = 0.016
AMB_TEMP = 80.0

#: ops/cell used for the GFlops print.
FLOPS_PER_CELL = 15

f32 = np.float32


@cell_type
class HotspotCell:
    temp: torch.Tensor
    power: torch.Tensor


@transition_function
class HotspotKernel:
    """Rodinia update with boundary handling *inside* the transition
    function: at grid edges the missing neighbor is replaced by the centre
    temperature (``hotspot.cpp:69-96``)."""

    stencil_radius = 1
    n_subiterations = 1
    #: The device functor ``ss::HotspotOp`` (csrc/ops/hotspot.cuh): it
    #: updates ``temp``; ``power`` is loop-invariant and never written.
    cuda_op = "hotspot"
    cuda_variant = ("temp",)
    #: Float32 operations per cell and iteration that the update does on
    #: cell data, a fused multiply-add counted as two: power + AMB*Rz, b + t,
    #: fma, r + l, fma, acc * Cap, fma. ``old_coef`` and ``AMB*Rz`` are
    #: constants of the launch. (``FLOPS_PER_CELL`` is Rodinia's count, kept
    #: for its GFlops print.)
    n_operations = 10
    Rx_1: float = 0.0
    Ry_1: float = 0.0
    Rz_1: float = 0.0
    Cap_1: float = 0.0

    def cuda_params(self) -> tuple[float, float, float, float]:
        """The functor's scalar parameters, in its order."""
        return self.Rx_1, self.Ry_1, self.Rz_1, self.Cap_1

    def __call__(self, s):
        center = s[0, 0]
        old = center.temp
        power = center.power

        h, w = s.grid_range
        top = torch.where(s.row == 0, old, s[-1, 0].temp)
        bottom = torch.where(s.row == h - 1, old, s[1, 0].temp)
        left = torch.where(s.col == 0, old, s[0, -1].temp)
        right = torch.where(s.col == w - 1, old, s[0, 1].temp)

        # The JAX package's association, constants folded in float32
        # (hotspot.py:95-109 there):
        #   new = old * (1 - Cap*(2Ry+2Rx+Rz)) + Cap*(power + AMB*Rz
        #         + (b+t)*Ry + (r+l)*Rx)
        # XLA on the CPU fuses four multiply-adds, old_coef's included, and so
        # does the device functor (__fmaf_rn). The coefficients are float32
        # tensors (0-d): a parameter given as a tensor keeps its autograd
        # graph, one given as a number rounds to float32 as before.
        rx, ry, rz, cap = (torch.as_tensor(v, dtype=torch.float32) for v in self.cuda_params())
        conductance = (2.0 * ry + 2.0 * rx + rz).reshape(1)
        old_coef = fma_f32(conductance, -cap, torch.ones_like(conductance))[0]
        acc = power + rz * float(f32(AMB_TEMP))
        acc = fma_f32(bottom + top, ry, acc)
        acc = fma_f32(right + left, rx, acc)
        new_temp = fma_f32(old, old_coef, acc * cap)
        return HotspotCell(temp=new_temp, power=power)

    def get_time_dependent_value(self, i):
        return None


def derive_coefficients(n_rows: int, n_cols: int) -> HotspotKernel:
    """Physics-to-coefficients derivation (``hotspot.cpp:281-295``)."""
    grid_height = CHIP_HEIGHT / n_rows
    grid_width = CHIP_WIDTH / n_cols

    cap = FACTOR_CHIP * SPEC_HEAT_SI * T_CHIP * grid_height * grid_width
    rx = grid_width / (2.0 * K_SI * T_CHIP * grid_height)
    ry = grid_height / (2.0 * K_SI * T_CHIP * grid_width)
    rz = T_CHIP / (K_SI * grid_height * grid_width)

    max_slope = MAX_PD / (FACTOR_CHIP * T_CHIP * SPEC_HEAT_SI)
    step = PRECISION / max_slope / 1000.0

    return HotspotKernel(
        Rx_1=np.float32(1.0 / rx),
        Ry_1=np.float32(1.0 / ry),
        Rz_1=np.float32(1.0 / rz),
        Cap_1=np.float32(step / cap),
    )


def read_input(
    temp_file: str, power_file: str, n_rows: int, n_cols: int, binary: bool, *, device
) -> Grid:
    reader = read_float_grid_binary if binary else read_float_grid_text
    return Grid.from_numpy(
        HotspotCell(
            temp=reader(temp_file, n_rows, n_cols), power=reader(power_file, n_rows, n_cols)
        ),
        device=device,
    )


def run(grid: Grid, n_iterations: int, backend: str = "auto", kernel=None, **backend_kwargs):
    """``n_iterations`` of HotSpot on ``grid``; returns ``(grid, update)``."""
    if kernel is None:
        kernel = derive_coefficients(grid.height, grid.width)
    update = create_update(
        Params(
            transition_function=kernel,
            halo_value=HotspotCell(temp=0.0, power=0.0),
            n_iterations=n_iterations,
            blocking=True,
        ),
        backend=backend,
        **backend_kwargs,
    )
    return update(grid), update


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="hotspot", description="Rodinia HotSpot transient thermal simulation"
    )
    parser.add_argument("grid_rows", type=int)
    parser.add_argument("grid_cols", type=int)
    parser.add_argument("sim_time", type=int, help="number of iterations")
    parser.add_argument("temp_file")
    parser.add_argument("power_file")
    parser.add_argument("output_file")
    parser.add_argument("--backend", default="auto")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)

    binary = args.temp_file.endswith(".bin")
    if binary and not args.power_file.endswith(".bin"):
        parser.error("temp and power files must both be binary or both text")

    grid = read_input(
        args.temp_file, args.power_file, args.grid_rows, args.grid_cols, binary,
        device=torch.device(args.device),
    )
    print("Start computing the transient temperature")
    out, update = run(grid, args.sim_time, backend=args.backend)
    print("Ending simulation")
    print(f"Walltime: {update.get_walltime()} s")
    gflops = (
        args.grid_rows * args.grid_cols * args.sim_time * FLOPS_PER_CELL
        / update.get_walltime() / 1.0e9
    )
    print(f"GFlops: {gflops}")

    temps = out.to_numpy().temp
    if binary:
        write_float_grid_binary(args.output_file, temps)
    else:
        write_indexed_text(args.output_file, temps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
