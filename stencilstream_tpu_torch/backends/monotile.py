"""Monotile backend: the whole grid resident on chip, all iterations of a call
in one kernel launch.

Counterpart of ``stencilstream_tpu/backends/monotile.py``. The wrapper
:func:`monotile` launches the resident-grid CUDA kernel
(``csrc/monotile.cu``), which replaces the TPU kernel ``_run_monotile``: one
cooperative launch in which each CTA keeps a band of full-width rows in
shared memory with a deep halo of ``q*r`` rows a side, runs ``q`` sub-steps
on a narrowing window, and then trades ``q*r`` rows with the CTAs beside it
through L2, waiting on their flags only.

* On CPU tensors :func:`monotile` runs :func:`monotile_plain`, the same
  function on whole grids, built on :mod:`.reference`.
* On CUDA tensors it launches the kernel, or raises.

Both read a step's time-dependent value from the call's TDV stream ``tdv``
(element ``i_abs - offset``), the inline strategy's when none is given.

The capacity law replaces the TPU's VMEM budget: with one CTA per SM, a band
is ``ceil(H / SMs)`` rows (at least r), and the band plus ``2r`` halo rows,
times the width plus ``2r``, times :func:`~.cuda_lib.cell_smem_bytes` (two
copies of each variant field, one of each invariant field), must fit the
shared memory one block may use. Both numbers come from the device's
properties. Grids beyond it raise a ``ValueError`` that points at
``tiling``; ``auto`` applies the same law. Within it, :data:`MONO_LAW` picks
the sub-steps per exchange ``q`` and the threads per CTA, and
:func:`monotile_plan` falls back to smaller ``q``, down to 1, where the deep
halo does not fit.
"""

from __future__ import annotations

import ctypes
from typing import Any, NamedTuple

import torch

from ..core.cell import cell_leaves
from ..core.grid import Grid
from ..tdv import tdv_stream
from .base import StencilUpdateBase, resolve_halo
from .cuda_lib import (
    DeviceLimits,
    cell_smem_bytes,
    check,
    device_limits,
    entry,
    kernel_fields,
    pointer_array,
    require_device_op,
    tdv_pointer,
    with_variant,
)
from .reference import run_iterations

__all__ = [
    "MONO_LAW",
    "StencilUpdate",
    "MonotilePlan",
    "monotile",
    "monotile_plain",
    "monotile_plan",
    "monotile_residency",
    "monotile_smem_bytes",
    "launches",
]

#: Kernel launches made by :func:`monotile` (CUDA tensors only).
launches = 0

#: The resident-grid geometry that ran fastest on an NVIDIA H100 80GB HBM3
#: at 700 W (``tile_sweep.py``, monotile part, n=1000; PERF.md), by the
#: shared-memory bytes of one cell (:func:`~.cuda_lib.cell_smem_bytes`):
#: ``(q, threads per CTA)``. Jacobi5 8 B and HotSpot 12 B at 1024^2 (8-row
#: bands), the probe 40 B at 600^2 (5-row bands; q=2 is the most that fits),
#: FDTD's coef cell 48 B at 512^2 (4-row bands; q=2, the most that fits:
#: 10.70 ms for n=1000 against 13.59 at q=1 and 19.58 with two CTAs of 512).
#: Two CTAs of 512 threads an SM (bands half as tall) lost at every q, and
#: q=8 lost to q=4 for Jacobi5. Conway's 2 B cells were not swept and take
#: the smallest entry.
MONO_LAW = {
    8: (4, 1024),
    12: (4, 1024),
    40: (2, 1024),
    48: (2, 1024),
}
#: Threads a CTA of the kernel has at most (one CTA an SM).
MAX_THREADS = 1024
#: Shared memory the runtime keeps back per resident CTA (Hopper), which
#: splits an SM's shared memory between two CTAs.
RESERVED_SMEM = 1024
#: ``unsigned`` words per CTA flag (``csrc/monotile.cu``: ``kFlagStride``).
FLAG_STRIDE = 32


class MonotilePlan(NamedTuple):
    band: int        # grid rows per CTA
    n_ctas: int
    smem_bytes: int  # shared memory per CTA with r halo rows a side (the capacity law's figure)
    q: int = 1       # sub-steps per halo exchange: the deep halo is q*r rows a side
    threads: int = MAX_THREADS  # threads per CTA


def law_entry(cell_bytes: int) -> tuple[int, int]:
    """The :data:`MONO_LAW` entry of the largest tabulated cell not larger
    than ``cell_bytes`` (the smallest one for a smaller cell)."""
    fits = [b for b in MONO_LAW if b <= cell_bytes]
    return MONO_LAW[max(fits) if fits else min(MONO_LAW)]


def monotile_smem_bytes(band: int, q: int, width: int, radius: int, cell_bytes: int) -> int:
    """Dynamic shared memory of one CTA (``csrc/monotile.cu``): the band and
    ``q*r`` halo rows a side, times the width and ``r`` halo columns a side,
    times the cell's bytes."""
    return (band + 2 * q * radius) * (width + 2 * radius) * cell_bytes


def smem_budget(limits: DeviceLimits, ctas_per_sm: int) -> int:
    """Shared memory each of ``ctas_per_sm`` CTAs may take on one SM."""
    if ctas_per_sm == 1:
        return limits.smem_per_block
    return (limits.smem_per_block + RESERVED_SMEM) // ctas_per_sm - RESERVED_SMEM


def monotile_plan(
    height: int, width: int, radius: int, cell_bytes: int, limits: DeviceLimits
) -> MonotilePlan | None:
    """The launch geometry of the resident-grid kernel, or ``None`` when the
    grid does not fit (see the module docstring).

    The law's CTAs per SM (``MAX_THREADS // threads``) are tried first, then
    one CTA per SM, which admits exactly the grids that fit with ``q = 1``.
    ``q`` is the law's, or the largest smaller one for which the deep halo
    fits and ``q*r <= band``.
    """
    q_law, threads = law_entry(cell_bytes)
    for per_sm in dict.fromkeys((MAX_THREADS // threads, 1)):
        band = max(radius, -(-height // (limits.sm_count * per_sm)))
        budget = smem_budget(limits, per_sm)
        smem = monotile_smem_bytes(band, 1, width, radius, cell_bytes)
        if smem > budget:
            continue
        q = q_law
        while q > 1 and (q * radius > band or monotile_smem_bytes(band, q, width, radius, cell_bytes) > budget):
            q -= 1
        return MonotilePlan(band, -(-height // band), smem, q, MAX_THREADS // per_sm)
    return None


def monotile_plain(
    arrays: Any,
    tf: Any,
    halo_cell: Any,
    *,
    offset: int,
    n_iterations: int,
    tdv: Any = None,
) -> Any:
    """The plain PyTorch version: ``n_iterations`` whole-grid iterations."""
    if tdv is None:
        tdv = tdv_stream(tf, offset, n_iterations, cell_leaves(arrays)[0].device)
    return run_iterations(arrays, tf, halo_cell, offset, n_iterations, tdv)


class _Exchange:
    """One stream's exchange buffer and CTA flags, kept from call to call.
    ``epoch`` is the largest value any flag holds: each launch counts its
    exchanges on from it."""

    def __init__(self) -> None:
        self.buffer: torch.Tensor | None = None
        self.flags: torch.Tensor | None = None
        self.epoch = 0


#: Exchange buffers by (device index, stream): they live as long as the
#: process, since a buffer's flags and its epoch must stay together across
#: calls and updaters; a stream's launches run in order, so they share one.
_exchanges: dict[tuple[int, int], _Exchange] = {}


def _exchange(device: torch.device, stream: int, n_bytes: int, n_ctas: int) -> _Exchange:
    ex = _exchanges.setdefault((device.index, stream), _Exchange())
    if ex.buffer is None or ex.buffer.numel() < n_bytes:
        ex.buffer = torch.empty(n_bytes, dtype=torch.uint8, device=device)
    if ex.flags is None or ex.flags.numel() < n_ctas * FLAG_STRIDE:
        ex.flags = torch.zeros(n_ctas * FLAG_STRIDE, dtype=torch.int32, device=device)
    return ex


@torch.no_grad()
def monotile(
    arrays: Any,
    tf: Any,
    halo_cell: Any,
    *,
    offset: int,
    n_iterations: int,
    tdv: Any = None,
    plan: MonotilePlan | None = None,
) -> Any:
    """All ``n_iterations`` in one launch; returns the new grid cell.
    ``tdv`` is the call's TDV stream (the inline strategy's when ``None``).

    ``plan`` fixes the launch geometry (default: :func:`monotile_plan`'s);
    the kernel refuses one whose CTAs cannot all be resident. On the card
    the variant fields of the result are new tensors and the invariant
    fields ARE the tensors of ``arrays``, so no caller may later write in
    place into a returned cell's fields without cloning them first.
    """
    global launches
    device = cell_leaves(arrays)[0].device
    if device.type == "cpu":
        return monotile_plain(
            arrays, tf, halo_cell, offset=offset, n_iterations=n_iterations, tdv=tdv
        )
    fields = kernel_fields(arrays, tf, halo_cell, offset)
    if tdv is None:
        tdv = tdv_stream(tf, offset, n_iterations, device)
    H, W = fields.variant[0].shape
    if plan is None:
        plan = require_plan(H, W, tf, cell_smem_bytes(arrays, tf), device_limits(device))
    r = tf.stencil_radius
    dst = [torch.empty_like(t) for t in fields.variant]
    stream = torch.cuda.current_stream(device).cuda_stream
    side_bytes = len(dst) * plan.q * r * (W + 2 * r) * dst[0].element_size()
    ex = _exchange(device, stream, 2 * plan.n_ctas * 2 * side_bytes, plan.n_ctas)
    fn = entry("ss_monotile_", fields.op)
    with torch.cuda.device(device):
        code = fn(
            pointer_array(fields.variant), pointer_array(dst), pointer_array(fields.invariant),
            H, W, plan.band, plan.n_ctas, plan.q, plan.threads, offset, n_iterations,
            fields.params, fields.halo, tdv_pointer(tf, tdv, n_iterations, device),
            ex.buffer.data_ptr(), ex.flags.data_ptr(),
            ex.epoch & 0xFFFFFFFF, stream,
        )
    check(code, "resident-grid kernel")
    steps = n_iterations * tf.n_subiterations
    ex.epoch += max(0, -(-steps // plan.q) - 1)  # the exchanges this launch made
    launches += 1
    return with_variant(arrays, fields, dst)


def monotile_residency(tf: Any, plan: MonotilePlan, width: int, device) -> int:
    """CTAs of the resident-grid kernel for ``tf``'s functor that one SM of
    the CUDA ``device`` holds at once at ``plan``'s band, ``q`` and
    threads, as the CUDA runtime's occupancy calculator reports it."""
    blocks = ctypes.c_int()
    fn = entry("ss_monotile_residency_", require_device_op(tf))
    with torch.cuda.device(device):
        code = fn(plan.band, plan.q, width, plan.threads, ctypes.byref(blocks))
    check(code, "resident-grid occupancy query")
    return blocks.value


def require_plan(height: int, width: int, tf: Any, cell_bytes: int, limits: DeviceLimits) -> MonotilePlan:
    """:func:`monotile_plan`, raising the capacity error when it is None."""
    plan = monotile_plan(height, width, tf.stencil_radius, cell_bytes, limits)
    if plan is None:
        band = max(tf.stencil_radius, -(-height // limits.sm_count))
        need = monotile_smem_bytes(band, 1, width, tf.stencil_radius, cell_bytes)
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
        plan = require_plan(H, W, tf, cell_smem_bytes(grid.arrays, tf), device_limits(grid.device))
        if n == 0:
            return grid
        return Grid(
            monotile(
                grid.arrays, tf, resolve_halo(p.halo_value, grid),
                offset=int(p.iteration_offset), n_iterations=n, tdv=self._tdv_stream(grid),
                plan=plan,
            )
        )
