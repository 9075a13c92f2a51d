"""The FDTD transition function: 2D TM-mode Yee update over a disk cavity.

Counterpart of ``stencilstream_tpu/models/fdtd/kernel.py``: two
sub-iterations (E then H), a Gaussian-enveloped cosine source wave delivered
as the time-dependent value (TDV), a magnetic-energy accumulator after the
detect iteration, and integer-valued distance scores for the radius tests.

:class:`FDTDKernel` is both the plain PyTorch transition function and the
name of its device functor (``csrc/ops/fdtd.cuh``, one per resolver), which
the CUDA kernels run with the same scalar parameters and the same TDV
stream. The update keeps the JAX package's float32 association and fuses
the multiply-adds that XLA fuses there (``core/fma.py:fma_f32`` here,
``__fmaf_rn`` in the functor): ``ex``, ``ey`` and ``hz`` as ``fma(field,
c, d * (difference))``, the disk source's ``fma(-d2, 1/r^2, 1)`` and
``hz_sum = fma(hz, hz, hz_sum)``; the source term itself is added unfused.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ...core import static_field, transition_function
from ...core.fma import fma_f32
from .params import Parameters

__all__ = ["FDTDKernel", "make_kernel"]

f32 = np.float32


@transition_function
class FDTDKernel:
    stencil_radius = 1
    n_subiterations = 2
    # The source wave is pure tensor math: the host precompute evaluates it
    # in one batched call.
    tdv_host_batchable = True
    #: The device functor's variant fields; the rest of the cell (the coef
    #: resolver's coefficients, the lut resolver's ring index) is invariant.
    cuda_variant = ("ex", "ey", "hz", "hz_sum")
    #: The fields each sub-step changes (the Yee leapfrog), each read only at
    #: the cell itself, as the functor declares them (``kWrites``): the tile
    #: pass updates them in place.
    cuda_writes = (("ex", "ey"), ("hz", "hz_sum"))
    #: The rows and columns each sub-step reads below and above a cell,
    #: ``(lo, hi)``, as the functor declares them (``kReach``): sub-step 0
    #: reads hz below, sub-step 1 ex and ey above; the tile pass's halo is
    #: then p, not r*p*k (``backends/tile_pass.py``: ``pass_halo``).
    cuda_reach = ((1, 0), (0, 1))
    #: The type of the TDV stream the functor reads: the source amplitude.
    cuda_tdv = torch.float32
    #: Float32 operations per cell and iteration on cell data, a fused
    #: multiply-add counted as two: ex and ey 4 each (difference, product,
    #: fma), hz 6 (three differences, product, fma), the source term 1,
    #: hz_sum 2, the source-distance score 5.
    n_operations = 22

    # Runtime parameters.
    dt: float = 0.0
    t_0: float = 0.0
    tau: float = 1.0
    omega: float = 0.0
    cutoff_iteration: int = 0
    detect_iteration: int = 0
    source_r: float = 0.0
    source_c: float = 0.0
    source_distance_bound: float = 0.0
    double_center_rc: float = 0.0
    resolver_state: object = None

    # Structural: the resolver policy and whether the source is a point
    # (radius 0) or an interpolated disk.
    resolver: object = static_field(default=None)
    source_radius_squared: float = static_field(default=0.0)

    @property
    def cuda_op(self) -> str:
        """The functor of this kernel's resolver: ``fdtd_<resolver>``."""
        return self.resolver.cuda_op

    def inv_source_radius_squared(self) -> float:
        """The float32 reciprocal of the source radius squared (0 for a
        point source): XLA divides by the constant as a multiply by it."""
        srs = f32(self.source_radius_squared)
        return float(f32(1.0) / srs) if srs != 0 else 0.0

    def cuda_params(self) -> tuple:
        """The functor's scalar parameters, in its order, then the
        resolver's tables."""
        return (
            int(self.cutoff_iteration), int(self.detect_iteration),
            float(f32(self.source_r)), float(f32(self.source_c)),
            float(f32(self.source_distance_bound)), float(f32(self.source_radius_squared)),
            self.inv_source_radius_squared(), float(f32(self.double_center_rc)),
            *self.resolver.cuda_params(self.resolver_state),
        )

    def get_time_dependent_value(self, i_iteration):
        """Source amplitude ``cos(w t) * exp(-((t - t0)/tau)^2)``, ``t = i *
        dt``, in float32, for a Python int or an int32 tensor of indices.

        ``t``, ``(t - t0) / tau`` and the two arguments are float32
        operations as in the JAX package; ``cos`` and ``exp`` are evaluated
        in float64 and rounded to float32 (correctly rounded, and the same
        for an index wherever it sits in a batch), then multiplied in
        float32. XLA's float32 ``cos`` is less accurate at large arguments,
        so the two packages' amplitudes differ by up to a few 1e-5.
        """
        i = torch.as_tensor(i_iteration, dtype=torch.int32)
        t = i.to(torch.float32) * float(f32(self.dt))
        # A float32 quotient, correctly rounded (exact in float64, then rounded).
        progress = ((t - float(f32(self.t_0))).double() / float(f32(self.tau))).float()
        wave = torch.cos((t * float(f32(self.omega))).double()).float()
        envelope = torch.exp((-progress * progress).double()).float()
        return wave * envelope

    def __call__(self, s):
        cell = s[0, 0]
        r = s.row.to(torch.float32)
        c = s.col.to(torch.float32)

        # Integer-valued distance scores, exact in float32.
        dcrc = float(f32(self.double_center_rc))
        center_score = r * (r - dcrc) + c * (c - dcrc)
        mat = self.resolver.coefficients(self.resolver_state, cell, center_score)

        if s.subiteration == 0:
            ex = fma_f32(cell.ex, mat.ca, mat.cb * (cell.hz - s[0, -1].hz))
            ey = fma_f32(cell.ey, mat.ca, mat.cb * (s[-1, 0].hz - cell.hz))
            return dataclasses.replace(cell, ex=ex, ey=ey)

        hz = fma_f32(cell.hz, mat.da, mat.db * (s[0, 1].ex - cell.ex + cell.ey - s[1, 0].ey))

        sr, sc = float(f32(self.source_r)), float(f32(self.source_c))
        source_score = r * (r - 2.0 * sr) + c * (c - 2.0 * sc)
        in_source = (source_score <= float(f32(self.source_distance_bound))) & (
            int(s.iteration) <= int(self.cutoff_iteration)
        )
        amplitude = torch.as_tensor(s.time_dependent_value, dtype=torch.float32, device=hz.device)
        if self.source_radius_squared != 0.0:
            cell_distance_squared = source_score + sc * sc + sr * sr
            interp = fma_f32(-cell_distance_squared, self.inv_source_radius_squared(),
                             torch.ones_like(hz))
            source = interp * amplitude
        else:
            source = amplitude
        hz = hz + torch.where(in_source, source, 0.0)

        detecting = int(s.iteration) > int(self.detect_iteration)
        hz_sum = fma_f32(hz, hz, cell.hz_sum) if detecting else cell.hz_sum
        return dataclasses.replace(cell, hz=hz, hz_sum=hz_sum)


def make_kernel(parameters: Parameters, resolver) -> FDTDKernel:
    """Derive all kernel constants from the experiment parameters, as the
    JAX package's ``make_kernel`` does."""
    dt = parameters.dt()
    source_r = float(parameters.source_r())
    source_c = float(parameters.source_c())
    srs = parameters.source_radius / parameters.dx
    srs = srs * srs
    source_distance_bound = (
        (parameters.source_radius / parameters.dx) ** 2 - source_c * source_c - source_r * source_r
    )
    return FDTDKernel(
        dt=np.float32(dt),
        t_0=np.float32(parameters.t_0()),
        tau=np.float32(parameters.tau),
        omega=np.float32(parameters.omega()),
        cutoff_iteration=int(math.floor(parameters.t_cutoff() / dt)),
        detect_iteration=int(math.floor(parameters.t_detect() / dt)),
        source_r=np.float32(source_r),
        source_c=np.float32(source_c),
        source_distance_bound=np.float32(source_distance_bound),
        double_center_rc=np.float32(parameters.grid_range()[0]),
        resolver_state=resolver.kernel_state(),
        resolver=resolver,
        source_radius_squared=float(np.float32(srs)),
    )
