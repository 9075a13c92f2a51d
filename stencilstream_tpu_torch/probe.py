"""The self-verifying probe cell, on the PyTorch/CUDA port.

Counterpart of the JAX package's test fixture ``tests/probe.py``. Each cell
carries its own (row, col) position, its iteration and sub-iteration
counters and a status flag. The probe transition function checks the whole
execution contract from inside the update: every neighbour inside the grid
must carry its own coordinates, the current iteration and sub-iteration and
Normal status; every neighbour outside the grid must equal the halo cell.
Valid cells advance their counters; any violation turns ``status`` Invalid
for good. A run is right when every output cell is Normal and advanced to
exactly ``iteration_offset + n_iterations`` (:func:`check_probe_grid`).

* :class:`ProbeTransFunc` is ``tests/probe.py``'s probe: its time-dependent
  value must equal the iteration index. At radius 1 and 2 with two
  sub-steps it names a device functor of ``csrc/ops/probe.cuh`` that reads
  the value from the call's int32 TDV stream, so on the card it checks the
  stream each kernel reads as well as the kernel's index algebra.
* :class:`ProbeKernel` is the same probe without a time-dependent value. It
  names the device functor ``csrc/ops/probe.cuh:ProbeOp``, which checks the
  neighbours' iteration counters against the kernel's own iteration
  index, so the probe runs on every kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from .core import Grid, cell_type, static_field, transition_function

__all__ = [
    "NORMAL",
    "INVALID",
    "HALO",
    "ProbeCell",
    "ProbeKernel",
    "ProbeTransFunc",
    "TDV_FUNCTORS",
    "check_probe_grid",
    "make_probe_grid",
    "probe_halo_cell",
]

NORMAL = 0
INVALID = 1
HALO = 2


@cell_type
class ProbeCell:
    r: torch.Tensor
    c: torch.Tensor
    i_iteration: torch.Tensor
    i_subiteration: torch.Tensor
    status: torch.Tensor


def probe_halo_cell() -> ProbeCell:
    return ProbeCell(r=0, c=0, i_iteration=0, i_subiteration=0, status=HALO)


def probe_step(stencil, radius: int, n_subiterations: int, tdv_ok=True) -> ProbeCell:
    """One probe sub-step over a block of cells; ``tdv_ok`` is folded into
    the validity of every cell."""
    center = stencil[0, 0]
    h, w = stencil.grid_range
    halo = probe_halo_cell()
    valid = torch.ones_like(center.r, dtype=torch.bool) & tdv_ok
    for dr in range(-radius, radius + 1):
        for dc in range(-radius, radius + 1):
            nb = stencil[dr, dc]
            nb_r = stencil.row + dr
            nb_c = stencil.col + dc
            in_grid = (nb_r >= 0) & (nb_c >= 0) & (nb_r < h) & (nb_c < w)
            ok_in = (
                (nb.r == nb_r)
                & (nb.c == nb_c)
                & (nb.i_iteration == stencil.iteration)
                & (nb.i_subiteration == stencil.subiteration)
                & (nb.status == NORMAL)
            )
            ok_out = (
                (nb.r == halo.r)
                & (nb.c == halo.c)
                & (nb.i_iteration == halo.i_iteration)
                & (nb.i_subiteration == halo.i_subiteration)
                & (nb.status == halo.status)
            )
            valid &= torch.where(in_grid, ok_in, ok_out)
    last_sub = int(stencil.subiteration) == n_subiterations - 1
    return ProbeCell(
        r=center.r,
        c=center.c,
        i_iteration=center.i_iteration + 1 if last_sub else center.i_iteration,
        i_subiteration=torch.zeros_like(center.i_subiteration) if last_sub else center.i_subiteration + 1,
        status=torch.where(valid, NORMAL, INVALID).to(torch.int32),
    )


#: Device functors of :class:`ProbeTransFunc` by radius (two sub-steps).
TDV_FUNCTORS = {1: "probe_tdv", 2: "probe_radius2"}


@transition_function
class ProbeTransFunc:
    """The probe with a time-dependent value equal to the iteration index.
    With two sub-steps at radius 1 or 2 it runs on the CUDA kernels
    (:data:`TDV_FUNCTORS`); all five fields are variant."""

    radius_: int = static_field(default=1)
    n_subiterations_: int = static_field(default=2)
    cuda_variant = ("r", "c", "i_iteration", "i_subiteration", "status")
    cuda_tdv = torch.int32

    @property
    def cuda_op(self):
        return TDV_FUNCTORS.get(self.radius_) if self.n_subiterations_ == 2 else None

    def cuda_params(self) -> tuple:
        return ()

    @property
    def stencil_radius(self):
        return self.radius_

    @property
    def n_subiterations(self):
        return self.n_subiterations_

    def get_time_dependent_value(self, i_iteration):
        return torch.as_tensor(i_iteration, dtype=torch.int32)

    def __call__(self, stencil):
        tdv_ok = stencil.time_dependent_value == stencil.iteration
        return probe_step(stencil, self.radius_, self.n_subiterations_, tdv_ok)


@transition_function
class ProbeKernel:
    """The probe without a time-dependent value; radius 1, two sub-steps.
    Its device functor is ``ss::ProbeOp`` (csrc/ops/probe.cuh), which
    updates all five fields."""

    stencil_radius = 1
    n_subiterations = 2
    cuda_op = "probe"
    cuda_variant = ("r", "c", "i_iteration", "i_subiteration", "status")

    def cuda_params(self) -> tuple:
        return ()

    def get_time_dependent_value(self, i_iteration):
        return None

    def __call__(self, stencil):
        return probe_step(stencil, self.stencil_radius, self.n_subiterations)


def make_probe_grid(height: int, width: int, iteration_offset: int = 0, *, device="cuda") -> Grid:
    """A grid of self-describing cells at ``iteration_offset``; on the card
    unless ``device`` says otherwise."""
    rows, cols = np.indices((height, width))
    return Grid.from_numpy(
        ProbeCell(
            r=rows.astype(np.int32),
            c=cols.astype(np.int32),
            i_iteration=np.full((height, width), iteration_offset, np.int32),
            i_subiteration=np.zeros((height, width), np.int32),
            status=np.zeros((height, width), np.int32),
        ),
        device=device,
    )


def check_probe_grid(grid: Grid, expected_iteration: int) -> None:
    """Every cell must be Normal and advanced to exactly
    ``expected_iteration``; raises ``AssertionError`` otherwise."""
    out = grid.to_numpy()
    height, width = out.r.shape
    rows, cols = np.indices((height, width))
    np.testing.assert_array_equal(out.status, NORMAL, err_msg="probe cells flagged Invalid")
    np.testing.assert_array_equal(out.r, rows)
    np.testing.assert_array_equal(out.c, cols)
    np.testing.assert_array_equal(out.i_iteration, expected_iteration)
    np.testing.assert_array_equal(out.i_subiteration, 0)
