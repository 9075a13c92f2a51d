"""Conway's Game of Life — the minimal end-to-end example, on the
PyTorch/CUDA port.

Counterpart of ``stencilstream_tpu/models/conway.py``, with the same CLI:
``python -m stencilstream_tpu_torch.models.conway <height> <width>
<n_iterations>`` reads an ``X``/``.`` grid from stdin and writes the evolved
grid to stdout. Cells are ``torch.bool``; the CUDA kernels read and write
them through a uint8 view of the same bytes (``csrc/ops/conway.cuh``).
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..backends import create_update
from ..core import Grid, Params, transition_function
from ..utils.io import read_char_grid, write_char_grid

__all__ = ["ConwayKernel", "run", "main"]


@transition_function
class ConwayKernel:
    """Moore-neighborhood alive count + birth/survival rule."""

    stencil_radius = 1
    n_subiterations = 1
    #: The device functor ``ss::ConwayOp`` (csrc/ops/conway.cuh).
    cuda_op = "conway"
    cuda_variant = ()

    def cuda_params(self) -> tuple:
        return ()

    def __call__(self, stencil):
        alive = stencil[0, 0]
        count = torch.zeros(alive.shape, dtype=torch.int32, device=alive.device)
        for dr in (-1, 0, 1):
            for dc in (-1, 0, 1):
                if (dr, dc) != (0, 0):
                    count = count + stencil[dr, dc].to(torch.int32)
        survive = (count == 2) | (count == 3)
        born = count == 3
        return torch.where(alive, survive, born)

    def get_time_dependent_value(self, i_iteration):
        return None


def run(grid: Grid, n_iterations: int, backend: str = "auto", **backend_kwargs) -> tuple[Grid, object]:
    """``n_iterations`` generations; outside the grid every cell is dead."""
    update = create_update(
        Params(
            transition_function=ConwayKernel(),
            halo_value=False,
            n_iterations=n_iterations,
            blocking=True,
        ),
        backend=backend,
        **backend_kwargs,
    )
    return update(grid), update


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="conway", description="Conway's Game of Life over stdin/stdout"
    )
    parser.add_argument("height", type=int)
    parser.add_argument("width", type=int)
    parser.add_argument("n_iterations", type=int)
    parser.add_argument("--backend", default="auto")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)

    cells = read_char_grid(sys.stdin, args.height, args.width)
    grid = Grid.from_numpy(cells, device=torch.device(args.device))
    out, _ = run(grid, args.n_iterations, backend=args.backend)
    write_char_grid(sys.stdout, out.to_numpy())
    return 0


if __name__ == "__main__":
    sys.exit(main())
