"""Analytic performance model for stencil updates on an NVIDIA card.

Counterpart of ``stencilstream_tpu/bench/model.py``, the port of the
reference's model math (``scripts/benchmark-common.jl``):

* its GPU roofline is ``cells/s = 0.8 * HBM_BW / (2 * cell_size)``, one
  read and one write per cell and iteration (:75-167, :148-151, :197-199);
* temporal blocking (p fused iterations a pass) divides the passes by p and
  adds the halo that a pass re-reads and recomputes; a run's time is, pass
  by pass, the larger of its memory time and its compute time.

The compute term divides the transition function's own operation count
(``n_operations``, a fused multiply-add counted as two: HotSpot 10, Jacobi5
9, FDTD 22, convection 50) by the card's float peak for the cell's compute
dtype, outside the tensor cores. The memory term uses the reference's 0.8
derate of the data-sheet HBM rate. Fed the bytes and cells a configuration
really moves and computes (``bench.harness.model_inputs``), the model is a
**bound** on that configuration, not a calibrated prediction: no instruction rate
was measured on the card, so ``model_accuracy`` reads as the share of the
bound a run reached. With the derate, a run bound by memory alone could in
principle read up to 1/0.8; the port's kernels are bound by instruction throughput and read far
below 1, so the bench flags a share above 1.05 as a wiring fault.

:data:`H100_SXM` is the port's one table of the card's peaks:
``experiments/common.py`` and ``chip_smoke.py`` read their bounds from it.

Not ported, and why:

* ``count_vector_ops`` and ``invariant_fields`` walk a jaxpr to count the
  TPU's vector slots and the fields a kernel never writes. The port's
  transition functions declare both (``n_operations``; ``cuda_variant`` and
  ``cuda_invariant_reads``, read by ``backends.cuda_lib.cell_field_bytes``
  and ``cell_traffic_bytes``), and those are the counts used here. The
  calibrated ``vpu_vector_ops`` rate and the scaled tables of other TPU
  generations go with them.
* ``traced_col_payload_width`` told a traced program's row operands from
  its column operands by element count, which is unsound; the port's
  exchange moves exactly the strips :func:`exchange_report` counts.
"""

from __future__ import annotations

import dataclasses
import subprocess

import torch

__all__ = [
    "GpuSpec",
    "H100_SXM",
    "SHARE_LIMIT",
    "roofline_cells_per_s",
    "predicted_runtime",
    "model_report",
    "exchange_report",
]

#: A share of the bound (``model_accuracy``) above this is a wiring fault,
#: not a measurement.
SHARE_LIMIT = 1.05

#: NVLink 4's data-sheet rate between two H100 SXM cards, bytes a second in
#: each direction. Copies between two cards have never run on the port.
NVLINK4_BYTES_PER_S = 450e9


@dataclasses.dataclass(frozen=True)
class GpuSpec:
    """One card's peaks. Defaults: NVIDIA H100 SXM at 700 W, from NVIDIA's
    data sheet (dense rates, outside the tensor cores, a fused multiply-add
    counted as two operations)."""

    name: str = "NVIDIA H100 SXM, 700 W (data sheet)"
    hbm_bandwidth: float = 3.35e12  # bytes/s
    #: Achievable fraction of ``hbm_bandwidth``, the reference's derate
    #: (``benchmark-common.jl:148``).
    hbm_efficiency: float = 0.8
    flops_f32: float = 67e12  # float32 operations/s
    flops_f64: float = 34e12  # float64 operations/s
    #: Whether these peaks are the named device's own. ``detect`` returns
    #: the H100 SXM's rates for any other device and marks them so, and a
    #: share of the bound is then an estimate, not a gauge.
    peaks_of_this_device: bool = True

    def flop_rate(self, dtype: str = "float32") -> float:
        """The peak for a cell computed in ``dtype`` (``"float32"`` or
        ``"float64"``)."""
        return self.flops_f64 if str(dtype).endswith("float64") else self.flops_f32

    @staticmethod
    def detect(device=None) -> "GpuSpec":
        """The spec of ``device`` (default: CUDA device 0 when there is one,
        else the CPU). Never raises. For an H100 with HBM3 (the SXM card),
        :data:`H100_SXM`'s rates under the card's name and power limit as
        ``nvidia-smi`` gives them, e.g. ``"NVIDIA H100 80GB HBM3, 700.00
        W"``; for any other device the same rates, ``peaks_of_this_device``
        false and a name that says so."""
        try:
            if device is None:
                device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
            device = torch.device(device)
            if device.type != "cuda":
                return dataclasses.replace(
                    H100_SXM, name=f"{device.type}: H100 SXM data-sheet rates, not this device's",
                    peaks_of_this_device=False,
                )
            name = torch.cuda.get_device_properties(device).name
            try:
                from ..experiments.common import card_line

                line = card_line(device)
            except (OSError, subprocess.SubprocessError, IndexError):
                line = f"{name}, power limit not read"
            if "H100" in name and "HBM3" in name:
                return dataclasses.replace(H100_SXM, name=line)
            return dataclasses.replace(
                H100_SXM, name=f"{line}: H100 SXM data-sheet rates, not this card's", peaks_of_this_device=False
            )
        except Exception as e:  # the bench's report must never fail for want of a name
            return dataclasses.replace(
                H100_SXM, name=f"unknown device ({type(e).__name__}): H100 SXM data-sheet rates",
                peaks_of_this_device=False,
            )


#: The port's one table of the card's peaks.
H100_SXM = GpuSpec()


def roofline_cells_per_s(spec: GpuSpec, cell_bytes: int) -> float:
    """Single-pass HBM roofline: one read and one write per cell and
    iteration (the reference's GPU model, ``benchmark-common.jl:148-151``)."""
    return spec.hbm_efficiency * spec.hbm_bandwidth / (2.0 * cell_bytes)


def predicted_runtime(
    spec: GpuSpec,
    grid_cells: int,
    n_iterations: int,
    cell_bytes: int,
    *,
    iters_per_pass: int = 1,
    halo_overhead: float = 0.0,
    compute_overhead: float | None = None,
    flops_per_cell: float = 0.0,
    dtype: str = "float32",
) -> float:
    """Model runtime, in seconds, of a temporally blocked run.

    Per pass of ``p = iters_per_pass`` iterations the grid moves ``(2 +
    halo_overhead)`` cell sizes of HBM traffic (read and write, plus what the
    configuration re-reads; negative where fields are read and never
    written) and computes ``(1 + compute_overhead)`` grids' worth of ``p *
    flops_per_cell`` operations a cell at the peak of ``dtype``. A pass
    takes the larger of the two: the bandwidth/compute crossover, the
    counterpart of the reference's effective-clock bound
    (``benchmark-common.jl:75-96``).
    """
    p = max(iters_per_pass, 1)
    n_passes = -(-n_iterations // p)
    if compute_overhead is None:
        compute_overhead = halo_overhead
    bytes_per_pass = grid_cells * cell_bytes * (2.0 + halo_overhead)
    mem_time = bytes_per_pass / (spec.hbm_efficiency * spec.hbm_bandwidth)
    compute_time = grid_cells * (1.0 + compute_overhead) * p * flops_per_cell / spec.flop_rate(dtype)
    return n_passes * max(mem_time, compute_time)


def model_report(
    spec: GpuSpec,
    grid_cells: int,
    n_iterations: int,
    cell_bytes: int,
    measured_walltime: float,
    *,
    flops_per_cell: float = 0.0,
    dtype: str = "float32",
    **model_kwargs,
) -> dict:
    """Measured against modeled, in the reference's report vocabulary
    (``benchmark-common.jl:124-173``): ``measured_cells_per_s``,
    ``model_accuracy`` (measured over modeled: the share of the bound, see
    the module docstring; meaningful when the caller passes the
    configuration that ran: ``iters_per_pass``, ``halo_overhead`` and
    ``compute_overhead``), ``occupancy_vs_roofline`` (measured over the
    single-pass roofline, which temporally blocked runs may exceed),
    ``flop_utilization`` (useful operations a second over the peak of
    ``dtype``) and ``hardware`` (``spec.name``)."""
    measured = grid_cells * n_iterations / measured_walltime
    modeled_t = predicted_runtime(
        spec, grid_cells, n_iterations, cell_bytes, flops_per_cell=flops_per_cell, dtype=dtype, **model_kwargs
    )
    modeled = grid_cells * n_iterations / modeled_t if modeled_t else float("inf")
    roof = roofline_cells_per_s(spec, cell_bytes)
    return {
        "hardware": spec.name,
        "measured_cells_per_s": measured,
        "modeled_cells_per_s": modeled,
        "model_accuracy": measured / modeled if modeled else 0.0,
        "single_pass_roofline_cells_per_s": roof,
        "occupancy_vs_roofline": measured / roof,
        "flop_utilization": measured * flops_per_cell / spec.flop_rate(dtype),
        "compute_dtype": str(dtype),
        "peaks_of_this_device": spec.peaks_of_this_device,
    }


def exchange_report(
    spec: GpuSpec,
    mesh_shape: tuple[int, int],
    grid_shape: tuple[int, int],
    cell_bytes: int,
    *,
    radius: int,
    iters_per_pass: int,
    n_subiterations: int = 1,
    link_bandwidth: float = NVLINK4_BYTES_PER_S,
) -> dict:
    """The halo exchange of one pass of the ``distributed`` backend, as
    :func:`..parallel.exchange_halo` moves it: a halo of ``hp = r * p * k``
    rows along a sharded mesh axis and ``hp`` columns along the other,
    rows first, the columns then spanning the row-extended block; each frame
    strip written once, no alignment or packing. Shards are those of
    ``backends/distributed.py`` (the grid padded to a multiple of the mesh,
    each block at least ``hp`` along a sharded axis). ``cell_bytes`` is
    what moves per cell: after a call's first exchange only the variant
    fields move.

    * ``row_bytes`` / ``col_bytes``: one block's frame a pass, both sides,
      as the exchange writes it (the strips at a mesh edge are zero-filled
      rather than copied from a neighbour);
    * ``moved_bytes``: the strips copied from a neighbour over the whole
      mesh a pass;
    * ``exchange_time_s``: a block's frame over ``link_bandwidth`` (NVLink
      4's data-sheet 450 GB/s a direction by default);
    * ``exchange_fraction``: that over the pass's HBM time for one shard
      (one read and one write of its cells), the decision metric for
      exchanging halos every pass against recomputing them.
    """
    ny, nx = mesh_shape
    H, W = grid_shape
    hp = radius * iters_per_pass * n_subiterations
    h = max(-(-H // ny), hp if ny > 1 else 1)
    w = max(-(-W // nx), hp if nx > 1 else 1)
    hr, hc = (hp if ny > 1 else 0), (hp if nx > 1 else 0)
    row_bytes = 2 * hr * w * cell_bytes
    col_bytes = 2 * hc * (h + 2 * hr) * cell_bytes
    moved = (nx * 2 * (ny - 1) * hr * w + ny * 2 * (nx - 1) * hc * (h + 2 * hr)) * cell_bytes
    hbm_time = 2.0 * h * w * cell_bytes / (spec.hbm_efficiency * spec.hbm_bandwidth)
    exchange_time = (row_bytes + col_bytes) / link_bandwidth
    return {
        "row_bytes": row_bytes,
        "col_bytes": col_bytes,
        "moved_bytes": moved,
        "exchange_time_s": exchange_time,
        "exchange_fraction": exchange_time / hbm_time if hbm_time else 0.0,
    }
