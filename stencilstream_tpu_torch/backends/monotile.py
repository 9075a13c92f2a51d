"""Monotile backend: the whole grid resident on chip, all iterations of a call
in one kernel launch.

Counterpart of ``stencilstream_tpu/backends/monotile.py``. The wrapper
:func:`monotile` launches the resident-grid CUDA kernel
(``csrc/monotile.cu``), which replaces the TPU kernel ``_run_monotile``: one
cooperative launch in which each CTA keeps a band of full-width rows in
shared memory and trades r halo rows with its neighbours every sub-step
through L2, behind a grid-wide barrier.

* On CPU tensors :func:`monotile` runs :func:`monotile_plain`, the same
  function on whole grids, built on :mod:`.reference`.
* On CUDA tensors it launches the kernel, or raises.

The capacity law replaces the TPU's VMEM budget: with one CTA per SM, a band
is ``ceil(H / SMs)`` rows (at least r), and the band plus ``2r`` halo rows,
times the width plus ``2r``, times :func:`~.cuda_lib.cell_smem_bytes` (two
copies of each variant field, one of each invariant field), must fit the
shared memory one block may use. Both numbers come from the device's
properties. Grids beyond it raise a ``ValueError`` that points at
``tiling``; ``auto`` applies the same law.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from ..core.cell import cell_leaves
from ..core.grid import Grid
from .base import StencilUpdateBase, resolve_halo
from .cuda_lib import (
    DeviceLimits,
    cell_smem_bytes,
    check,
    device_limits,
    entry,
    kernel_fields,
    pointer_array,
    with_variant,
)
from .reference import run_iterations

__all__ = ["StencilUpdate", "MonotilePlan", "monotile", "monotile_plain", "monotile_plan", "launches"]

#: Kernel launches made by :func:`monotile` (CUDA tensors only).
launches = 0


class MonotilePlan(NamedTuple):
    band: int        # grid rows per CTA
    n_ctas: int
    smem_bytes: int  # dynamic shared memory per CTA


def monotile_plan(
    height: int, width: int, radius: int, cell_bytes: int, limits: DeviceLimits
) -> MonotilePlan | None:
    """The launch geometry of the resident-grid kernel, or ``None`` when the
    grid does not fit (see the module docstring)."""
    band = max(radius, -(-height // limits.sm_count))
    smem = (band + 2 * radius) * (width + 2 * radius) * cell_bytes
    if smem > limits.smem_per_block:
        return None
    return MonotilePlan(band, -(-height // band), smem)


def monotile_plain(
    arrays: Any,
    tf: Any,
    halo_cell: Any,
    *,
    offset: int,
    n_iterations: int,
    tdv_lookup: Callable[[int, int], Any] | None = None,
) -> Any:
    """The plain PyTorch version: ``n_iterations`` whole-grid iterations."""
    if tdv_lookup is None:
        tdv_lookup = lambda i_rel, i_abs: tf.get_time_dependent_value(i_abs)  # noqa: E731
    return run_iterations(arrays, tf, halo_cell, offset, n_iterations, tdv_lookup)


@torch.no_grad()
def monotile(
    arrays: Any,
    tf: Any,
    halo_cell: Any,
    *,
    offset: int,
    n_iterations: int,
    tdv_lookup: Callable[[int, int], Any] | None = None,
) -> Any:
    """All ``n_iterations`` in one launch; returns the new grid cell.

    On the card the variant fields of the result are new tensors and the
    invariant fields ARE the tensors of ``arrays``, so no caller may later
    write in place into a returned cell's fields without cloning them first.
    """
    global launches
    device = cell_leaves(arrays)[0].device
    if device.type == "cpu":
        return monotile_plain(
            arrays, tf, halo_cell, offset=offset, n_iterations=n_iterations, tdv_lookup=tdv_lookup
        )
    fields = kernel_fields(arrays, tf, halo_cell, offset)
    H, W = fields.variant[0].shape
    plan = require_plan(H, W, tf, cell_smem_bytes(arrays, tf), device_limits(device))
    r = tf.stencil_radius
    dst = [torch.empty_like(t) for t in fields.variant]
    dtype = fields.variant[0].dtype
    xchg = torch.empty(2 * plan.n_ctas * 2 * len(dst) * r * W, dtype=dtype, device=device)
    fn = entry("ss_monotile_", fields.op)
    with torch.cuda.device(device):
        code = fn(
            pointer_array(fields.variant), pointer_array(dst), pointer_array(fields.invariant),
            H, W, plan.band, plan.n_ctas, offset, n_iterations,
            fields.params, fields.halo, xchg.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    check(code, "resident-grid kernel")
    launches += 1
    return with_variant(arrays, fields, dst)


def require_plan(height: int, width: int, tf: Any, cell_bytes: int, limits: DeviceLimits) -> MonotilePlan:
    """:func:`monotile_plan`, raising the capacity error when it is None."""
    plan = monotile_plan(height, width, tf.stencil_radius, cell_bytes, limits)
    if plan is None:
        band = max(tf.stencil_radius, -(-height // limits.sm_count))
        need = (band + 2 * tf.stencil_radius) * (width + 2 * tf.stencil_radius) * cell_bytes
        raise ValueError(
            f"a {height}x{width} grid needs {need} B of shared memory per CTA "
            f"({limits.sm_count} CTAs of {band} rows); the monotile backend keeps the "
            f"whole grid resident in shared memory ({limits.smem_per_block} B per block). "
            f"Use the tiling backend for larger grids."
        )
    return plan


class StencilUpdate(StencilUpdateBase):
    """Monotile (shared-memory-resident) stencil updater."""

    @torch.no_grad()
    def _update(self, grid: Grid) -> Grid:
        p = self.params
        tf = p.transition_function
        n = int(p.n_iterations)
        H, W = grid.shape
        require_plan(H, W, tf, cell_smem_bytes(grid.arrays, tf), device_limits(grid.device))
        if n == 0:
            return grid
        return Grid(
            monotile(
                grid.arrays, tf, resolve_halo(p.halo_value, grid),
                offset=int(p.iteration_offset), n_iterations=n, tdv_lookup=self._tdv_lookup(grid),
            )
        )
