"""Thermal convection — the 2D mantle-convection miniapp, on the PyTorch/CUDA port.

Counterpart of ``stencilstream_tpu/models/convection.py``: an 11-field
cell, two transition functions over one grid — the
pseudo-transient momentum/pressure update (k=3) and the thermal
advection/diffusion update (k=2) — a host convergence loop that reads five
masked maxima after each block of ``nerr`` iterations, and the adaptive
``dt`` written into the thermal update's live parameters before each
thermal step: one timestep a call of :meth:`Simulation.step`, which
:func:`run` loops over. The reference's cell is 11 doubles; ``float64`` and
``float32`` both run on the CUDA kernels.

The folded variant (``run(folded=True)``, :class:`FoldedConvectionCell`)
stores the coordinate masks as 12 invariant planes beside the 11 fields: 7
bool planes and 5 coefficient planes. A device functor has one element
type, so the kernels take the bool planes widened to the cell's float
dtype, a copy made on the device for each launch
(``backends/cuda_lib.py:widened``); the grid keeps its bool planes.

The active region is ``(nx, ny)`` inside an ``(nx+1, ny+1)`` grid; the
reference's coordinate guards are ``torch.where`` masks here and branches
in the device functors (``csrc/ops/convection.cuh``). Every tap that can
lie outside the grid is masked, so the halo value never reaches a cell of
the grid. ``x`` is the row index, ``y`` the column index.

The twins keep the JAX package's association and fuse the multiply-adds
that XLA fuses there, in float32 and float64 alike (``core/fma.py:fma``
here, ``__fmaf_rn``/``__fma_rn`` in the functors): see
:class:`PseudoTransientKernel` and :class:`ThermalSolverKernel`. Scalar
reciprocals and quotients are computed in the cell's dtype, as JAX
computes them on its traced scalars. Run it on the card::

    python -m stencilstream_tpu_torch.models.convection experiment.json outdir [--dtype float64] [--folded]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time

import numpy as np
import torch

from .. import tracing
from ..backends import create_update
from ..core import Grid, Params, cell_type, static_field, transition_function
from ..core.fma import fma
from ..utils.io import write_csv_frame

__all__ = [
    "ThermalConvectionCell",
    "FoldedConvectionCell",
    "PseudoTransientKernel",
    "FoldedPseudoTransientKernel",
    "ThermalSolverKernel",
    "Experiment",
    "zero_cell",
    "folded_zero_cell",
    "folded_planes",
    "make_pseudo_transient_kernel",
    "make_folded_pseudo_transient_kernel",
    "make_thermal_kernel",
    "init_grid",
    "init_folded_grid",
    "physics_cell",
    "Simulation",
    "run",
    "main",
    "FLOPS_PER_CELL",
]

#: ops/cell used by the reference benchmark harness
#: (examples/convection/scripts/benchmark.jl:14-18).
FLOPS_PER_CELL = 50

#: The fields in storage order (the JAX package's).
FIELDS = ("T", "Pt", "Vx", "Vy", "tau_xx", "tau_yy", "sigma_xy", "dVxd_tau", "dVyd_tau", "ErrV", "ErrP")
#: The folded cell's coordinate planes, after :data:`FIELDS` (the JAX
#: package's order): bool masks and the coefficient planes ``c_*``, ``a_*``.
PLANES = ("m_v", "m_p", "m_sig", "c_pt", "c_vx", "a_vx", "c_vy", "a_vy", "m_bx0", "m_bx1", "m_by0", "m_by1")
#: The bool planes among :data:`PLANES`.
BOOL_PLANES = ("m_v", "m_p", "m_sig", "m_bx0", "m_bx1", "m_by0", "m_by1")


@cell_type
class ThermalConvectionCell:
    T: torch.Tensor
    Pt: torch.Tensor
    Vx: torch.Tensor
    Vy: torch.Tensor
    tau_xx: torch.Tensor
    tau_yy: torch.Tensor
    sigma_xy: torch.Tensor
    dVxd_tau: torch.Tensor
    dVyd_tau: torch.Tensor
    ErrV: torch.Tensor
    ErrP: torch.Tensor


def zero_cell() -> ThermalConvectionCell:
    """The halo cell: every field 0 (rounded to the grid's dtype)."""
    return ThermalConvectionCell(**{f: 0.0 for f in FIELDS})


def physics_cell(arrays) -> ThermalConvectionCell:
    """The 11 physics fields of a cell (a folded one's, without its
    planes): the very tensors, nothing copied."""
    return ThermalConvectionCell(**{f: getattr(arrays, f) for f in FIELDS})


def _param_dtype(value) -> torch.dtype:
    """The cell dtype a parameter value names: float64 for a float64 numpy
    scalar or tensor, float32 otherwise (a Python float takes the JAX
    package's 32-bit default)."""
    dtype = getattr(value, "dtype", None)
    return torch.float64 if dtype in (np.float64, torch.float64) else torch.float32


def _scalars(dtype: torch.dtype, **values) -> dict:
    """Each value rounded to ``dtype``, as a Python float (exact)."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    return {k: float(np_dtype(v)) for k, v in values.items()}


def _check_dtype(tf, field: torch.Tensor) -> None:
    if field.dtype != tf.dtype:
        raise TypeError(
            f"{type(tf).__name__} has {tf.dtype} parameters (functor {tf.cuda_op!r}), "
            f"but the grid's fields are {field.dtype}"
        )


@transition_function
class PseudoTransientKernel:
    """Momentum/pressure pseudo-transient iteration, k=3
    (``convection.cpp:76-183``).

    ``with_err=False`` (static) drops the ErrV/ErrP bookkeeping: the error
    fields are only read after each ``nerr``-block of the convergence loop,
    and every earlier iteration's Err writes are overwritten unread
    (sub-iteration 0 snapshots over them), so running ``nerr - 1`` lean
    iterations and one full one equals running full ones throughout.

    The multiply-adds XLA fuses (found by emulating the candidate forms in
    numpy against the JAX ``reference`` backend on random fields and
    parameters; the same forms in float32 and float64). With ``ax =
    d_xa_vx*inv_dx`` and ``ay = d_ya_vy*inv_dy``, ``delta_V`` is evaluated
    twice, once in each form:

    * sub-step 0: ``dV1 = fma(d_xa_vx, inv_dx, ay)``, ``dV2 = fma(d_ya_vy,
      inv_dy, ax)``; ``eta = eta0 * fma(-dedT, T + deltaT/2, 1)``; ``Pt =
      fma(-(dtau/beta), dV1, Pt)``; ``tau_xx = (2 eta) * fma(-1/3, dV2,
      ax)``; ``tau_yy = (2 eta) * fma(-1/3, dV1, ay)``; ``sigma_xy = eta *
      fma(d_xi_vy, inv_dx, d_yi_vx*inv_dy)``;
    * sub-step 1: ``Rx = (1/rho) * fma(-dPx, inv_dx, fma(dsx, inv_dy,
      dtxx*inv_dx))``; ``Ry = (1/rho) * fma(roh0_g_alpha, Tm, fma(-dPy,
      inv_dy, fma(dsy, inv_dx, dtyy*inv_dy)))``; ``dV?d_tau =
      fma(damp?, dV?d_tau, R?*dtau)``; ``V? = fma(dV?d_tau, dtau, V?)``;
    * sub-step 2 has no multiply.
    """

    stencil_radius = 1
    n_subiterations = 3
    # Every tap that can lie outside the grid is guarded by a coordinate
    # mask (the reference's ``if (x < nx && y < ny)`` pattern).
    handles_boundary = True
    #: Operations per cell and iteration, the reference harness's count.
    n_operations = FLOPS_PER_CELL

    nx: int = 0
    ny: int = 0
    roh0_g_alpha: float = 0.0
    delta_eta_delta_T: float = 0.0
    eta0: float = 0.0
    deltaT: float = 0.0
    dx: float = 1.0
    dy: float = 1.0
    delta_tau_iter: float = 0.0
    beta: float = 1.0
    rho: float = 1.0
    dampX: float = 0.0
    dampY: float = 0.0
    with_err: bool = static_field(default=True)

    @property
    def dtype(self) -> torch.dtype:
        """The cell's dtype: that of the parameters."""
        return _param_dtype(self.dx)

    @property
    def cuda_op(self) -> str:
        """``convection_pt[_lean]_{f32,f64}`` (``csrc/ops/convection.cuh``)."""
        width = "f64" if self.dtype == torch.float64 else "f32"
        return f"convection_pt_{width}" if self.with_err else f"convection_pt_lean_{width}"

    #: The only invariant field the functor reads (lean leaves ErrV and
    #: ErrP invariant and unread).
    cuda_invariant_reads = ("T",)

    @property
    def cuda_variant(self) -> tuple:
        """Every field but T; lean also leaves ErrV and ErrP invariant."""
        return FIELDS[1:] if self.with_err else FIELDS[1:-2]

    @property
    def cuda_writes(self) -> tuple:
        """The fields each sub-step changes, as the functor declares them
        (``kWrites``), so the tile pass updates the cells in place: Pt and
        the stresses; the velocities and their pseudo-time derivatives; the
        boundary velocities; with ErrV and ErrP in sub-steps 0 and 2."""
        err = ("ErrV", "ErrP") if self.with_err else ()
        return (("Pt", "tau_xx", "tau_yy", "sigma_xy", *err), ("Vx", "Vy", "dVxd_tau", "dVyd_tau"), ("Vx", "Vy", *err))

    #: The rows and columns each sub-step reads below and above a cell,
    #: ``(lo, hi)``, as the functor declares them (``kReach``): sub-step 0
    #: reads the velocities above, sub-step 1 the stresses, Pt and T below,
    #: sub-step 2 the boundary velocities on both sides; the tile pass's halo
    #: is then 2p, not r*p*k = 3p (``backends/tile_pass.py``: ``pass_halo``).
    cuda_reach = ((0, 1), (1, 0), (1, 1))

    def get_time_dependent_value(self, i):
        return None

    def scalars(self) -> dict:
        """The scalar operands of the update, each computed in the cell's
        dtype as JAX computes it on its traced scalars."""
        D = np.float64 if self.dtype == torch.float64 else np.float32
        one = D(1.0)
        return _scalars(
            self.dtype,
            inv_dx=one / D(self.dx), inv_dy=one / D(self.dy), third=D(1.0 / 3.0),
            dtau_beta=D(self.delta_tau_iter) / D(self.beta), dedT=D(self.delta_eta_delta_T),
            eta0=D(self.eta0), half_deltaT=D(self.deltaT) / D(2.0), inv_rho=one / D(self.rho),
            dtau=D(self.delta_tau_iter), dampX=D(self.dampX), dampY=D(self.dampY),
            g=D(self.roh0_g_alpha),
        )

    def cuda_params(self) -> tuple:
        """The functor's parameters, in its order: nx, ny, then
        :meth:`scalars`. Raises ``ValueError`` for an active region under
        3x3: the tile pass updates the cells in place, and sub-step 2's
        boundary copies would then read cells that other lanes change
        (``csrc/ops/convection.cuh``)."""
        nx, ny = int(self.nx), int(self.ny)
        if nx < 3 or ny < 3:
            raise ValueError(f"the device functor takes an active region of at least 3x3 (got nx={nx}, ny={ny})")
        return (nx, ny, *self.scalars().values())

    def __call__(self, s):
        c = s[0, 0]
        _check_dtype(self, c.T)
        x, y = s.row, s.col
        nx, ny = int(self.nx), int(self.ny)
        k = self.scalars()
        inv_dx, inv_dy = k["inv_dx"], k["inv_dy"]

        if s.subiteration == 0:
            mask_v = (x < nx) & (y < ny + 1)
            mask_p = (x < nx) & (y < ny)
            err_upd = {}
            if self.with_err:
                err_upd["ErrV"] = torch.where(mask_v, c.Vy, c.ErrV)
                err_upd["ErrP"] = torch.where(mask_p, c.Pt, c.ErrP)
            d_xa_vx = s[1, 0].Vx - c.Vx
            d_ya_vy = s[0, 1].Vy - c.Vy
            ax, ay = d_xa_vx * inv_dx, d_ya_vy * inv_dy
            dV1 = fma(d_xa_vx, inv_dx, ay)
            dV2 = fma(d_ya_vy, inv_dy, ax)
            eta = k["eta0"] * fma(c.T + k["half_deltaT"], -k["dedT"], torch.ones_like(c.T))
            two_eta = 2.0 * eta
            Pt = torch.where(mask_p, fma(dV1, -k["dtau_beta"], c.Pt), c.Pt)
            tau_xx = torch.where(mask_p, two_eta * fma(dV2, -k["third"], ax), c.tau_xx)
            tau_yy = torch.where(mask_p, two_eta * fma(dV1, -k["third"], ay), c.tau_yy)
            d_yi_vx = s[1, 1].Vx - s[1, 0].Vx
            d_xi_vy = s[1, 1].Vy - s[0, 1].Vy
            sigma_xy = torch.where(
                mask_p & (x < nx - 1) & (y < ny - 1),
                eta * fma(d_xi_vy, inv_dx, d_yi_vx * inv_dy),
                c.sigma_xy,
            )
            return dataclasses.replace(
                c, Pt=Pt, tau_xx=tau_xx, tau_yy=tau_yy, sigma_xy=sigma_xy, **err_upd
            )

        if s.subiteration == 1:
            inner = (x >= 1) & (y >= 1)
            mask_x = inner & (x < nx) & (y < ny - 1)
            sx = fma(s[-1, 0].sigma_xy - s[-1, -1].sigma_xy, inv_dy, (c.tau_xx - s[-1, 0].tau_xx) * inv_dx)
            Rx = k["inv_rho"] * fma(c.Pt - s[-1, 0].Pt, -inv_dx, sx)
            dVxd_tau = torch.where(mask_x, fma(c.dVxd_tau, k["dampX"], Rx * k["dtau"]), c.dVxd_tau)
            Vx = torch.where(mask_x, fma(dVxd_tau, k["dtau"], c.Vx), c.Vx)

            mask_y = inner & (x < nx - 1) & (y < ny)
            sy = fma(s[0, -1].sigma_xy - s[-1, -1].sigma_xy, inv_dx, (c.tau_yy - s[0, -1].tau_yy) * inv_dy)
            sy = fma(c.Pt - s[0, -1].Pt, -inv_dy, sy)
            Ry = k["inv_rho"] * fma((s[0, -1].T + c.T) * 0.5, k["g"], sy)
            dVyd_tau = torch.where(mask_y, fma(c.dVyd_tau, k["dampY"], Ry * k["dtau"]), c.dVyd_tau)
            Vy = torch.where(mask_y, fma(dVyd_tau, k["dtau"], c.Vy), c.Vy)
            return dataclasses.replace(c, dVxd_tau=dVxd_tau, Vx=Vx, dVyd_tau=dVyd_tau, Vy=Vy)

        # sub-iteration 2: boundary conditions + error update
        mask_bcx = (x < nx + 1) & (y < ny)
        Vx = torch.where(mask_bcx & (y == 0), s[0, 1].Vx, c.Vx)
        Vx = torch.where(mask_bcx & (y == ny - 1), s[0, -1].Vx, Vx)
        mask_bcy = (x < nx) & (y < ny + 1)
        Vy = torch.where(mask_bcy & (x == 0), s[1, 0].Vy, c.Vy)
        Vy = torch.where(mask_bcy & (x == nx - 1), s[-1, 0].Vy, Vy)
        err_upd = {}
        if self.with_err:
            err_upd["ErrV"] = torch.where(mask_bcy, c.ErrV - Vy, c.ErrV)
            err_upd["ErrP"] = torch.where((x < nx) & (y < ny), c.ErrP - c.Pt, c.ErrP)
        return dataclasses.replace(c, Vx=Vx, Vy=Vy, **err_upd)


@transition_function
class ThermalSolverKernel:
    """Temperature advection/diffusion + flux boundary conditions, k=2
    (``convection.cpp:185-242``).

    XLA's fused multiply-adds (found as for :class:`PseudoTransientKernel`;
    the same in float32 and float64), with ``qcx = -DcT * inv_dx`` and the
    differences ``d1 = T - T[-1,0]``, ``d2 = T[1,0] - T``, ``d3 = T -
    T[0,-1]``, ``d4 = T[0,1] - T``: ``qx = fma(qcx, d2, -(qcx*d1))``, ``qy =
    fma(qcy, d4, -(qcy*d3))``, ``dT_dt = -fma(qx, inv_dx, qy*inv_dy)``;
    the four upwind terms ``dT_dt - (V*d)*inv_d`` unfused; ``T = fma(dT_dt,
    dt, T)``.
    """

    stencil_radius = 1
    n_subiterations = 2
    handles_boundary = True  # same guard discipline as PseudoTransientKernel
    #: Operations per cell and iteration: four differences, two products
    #: and three fused multiply-adds (two operations each) in the diffusion,
    #: one product, two multiplies and a subtraction in each upwind term,
    #: and the update's fused multiply-add.
    n_operations = 27
    cuda_variant = ("T",)
    #: The invariant fields the functor reads: the upwind terms' velocities.
    cuda_invariant_reads = ("Vx", "Vy")

    nx: int = 0
    ny: int = 0
    dx: float = 1.0
    dy: float = 1.0
    dt: float = 0.0
    DcT: float = 0.0

    @property
    def dtype(self) -> torch.dtype:
        return _param_dtype(self.dx)

    @property
    def cuda_op(self) -> str:
        """``convection_thermal_{f32,f64}``."""
        return "convection_thermal_f64" if self.dtype == torch.float64 else "convection_thermal_f32"

    def get_time_dependent_value(self, i):
        return None

    def scalars(self) -> dict:
        D = np.float64 if self.dtype == torch.float64 else np.float32
        one = D(1.0)
        inv_dx, inv_dy = one / D(self.dx), one / D(self.dy)
        return _scalars(
            self.dtype, inv_dx=inv_dx, inv_dy=inv_dy, qcx=-D(self.DcT) * inv_dx,
            qcy=-D(self.DcT) * inv_dy, dt=D(self.dt),
        )

    def cuda_params(self) -> tuple:
        """nx, ny, then :meth:`scalars` (``dt`` is read on every launch)."""
        return (int(self.nx), int(self.ny), *self.scalars().values())

    def __call__(self, s):
        c = s[0, 0]
        _check_dtype(self, c.T)
        x, y = s.row, s.col
        nx, ny = int(self.nx), int(self.ny)

        if s.subiteration == 0:
            k = self.scalars()
            inv_dx, inv_dy = k["inv_dx"], k["inv_dy"]
            mask = (x > 0) & (y > 0) & (x < nx - 1) & (y < ny - 1)
            d1 = c.T - s[-1, 0].T
            d2 = s[1, 0].T - c.T
            d3 = c.T - s[0, -1].T
            d4 = s[0, 1].T - c.T
            qx = fma(d2, k["qcx"], -(k["qcx"] * d1))
            qy = fma(d4, k["qcy"], -(k["qcy"] * d3))
            dT_dt = -fma(qx, inv_dx, qy * inv_dy)
            vx1, vy1 = s[1, 0].Vx, s[0, 1].Vy
            dT_dt = torch.where(c.Vx > 0, dT_dt - (c.Vx * d1) * inv_dx, dT_dt)
            dT_dt = torch.where(vx1 < 0, dT_dt - (vx1 * d2) * inv_dx, dT_dt)
            dT_dt = torch.where(c.Vy > 0, dT_dt - (c.Vy * d3) * inv_dy, dT_dt)
            dT_dt = torch.where(vy1 < 0, dT_dt - (vy1 * d4) * inv_dy, dT_dt)
            return dataclasses.replace(c, T=torch.where(mask, fma(dT_dt, k["dt"], c.T), c.T))

        # sub-iteration 1: no_fluxY_T boundary conditions
        T = torch.where((x == nx - 1) & (y < ny), s[-1, 0].T, c.T)
        T = torch.where((x == 0) & (y < ny), s[1, 0].T, T)
        return dataclasses.replace(c, T=T)


# --------------------------------------------------------------------------- #
# Folded variant: coordinate masks precomputed into invariant cell planes    #
# --------------------------------------------------------------------------- #
@cell_type
class FoldedConvectionCell:
    """The 11 physics fields, then the precomputed coordinate planes
    (:data:`PLANES`), as in the JAX package.

    The coordinates never change, so the reference's coordinate guards are
    functions of position alone, computed once (:func:`folded_planes`):
    bool masks, and coefficient planes into which the accumulate-style
    updates fold their mask (``c_*`` zero and ``a_*`` one outside it). The
    planes are loop-invariant: no kernel writes them."""

    T: torch.Tensor
    Pt: torch.Tensor
    Vx: torch.Tensor
    Vy: torch.Tensor
    tau_xx: torch.Tensor
    tau_yy: torch.Tensor
    sigma_xy: torch.Tensor
    dVxd_tau: torch.Tensor
    dVyd_tau: torch.Tensor
    ErrV: torch.Tensor
    ErrP: torch.Tensor
    m_v: torch.Tensor  # bool: x<nx & y<ny+1 (Vy/ErrV region)
    m_p: torch.Tensor  # bool: x<nx & y<ny (pressure region)
    m_sig: torch.Tensor  # bool: m_p & x<nx-1 & y<ny-1
    c_pt: torch.Tensor  # m_p * delta_tau_iter/beta
    c_vx: torch.Tensor  # mask_x * delta_tau_iter
    a_vx: torch.Tensor  # 1 + mask_x*(dampX-1)
    c_vy: torch.Tensor  # mask_y * delta_tau_iter
    a_vy: torch.Tensor  # 1 + mask_y*(dampY-1)
    m_bx0: torch.Tensor  # bool: bc region & y==0
    m_bx1: torch.Tensor  # bool: bc region & y==ny-1
    m_by0: torch.Tensor  # bool: bc region & x==0
    m_by1: torch.Tensor  # bool: bc region & x==nx-1


def folded_zero_cell() -> FoldedConvectionCell:
    """The folded halo cell: every field 0, every bool plane False."""
    return FoldedConvectionCell(**{f: False if f in BOOL_PLANES else 0.0 for f in FIELDS + PLANES})


def folded_planes(e: "Experiment", shape, dtype=np.float32) -> dict:
    """The coordinate planes of :class:`FoldedConvectionCell` on a grid of
    ``shape``, as numpy arrays (the JAX package's ``folded_planes``).

    The coefficients equal the straight kernel's arithmetic bit for bit:
    each scalar parameter is rounded to ``dtype`` first and combined in
    ``dtype`` (the straight kernel computes ``dtype(delta_tau_iter) /
    dtype(beta)`` the same way)."""
    nx, ny = e.nx, e.ny
    x = np.arange(shape[0])[:, None]
    y = np.arange(shape[1])[None, :]
    bb = lambda v: np.broadcast_to(v, shape).copy()  # noqa: E731
    m_v = (x < nx) & (y < ny + 1)
    m_p = (x < nx) & (y < ny)
    inner = (x >= 1) & (y >= 1)
    mask_x = inner & (x < nx) & (y < ny - 1)
    mask_y = inner & (x < nx - 1) & (y < ny)
    mask_bcx = (x < nx + 1) & (y < ny)
    mask_bcy = (x < nx) & (y < ny + 1)
    dtau = dtype(e.delta_tau_iter)
    dtau_over_beta = dtype(dtau / dtype(e.beta))
    sel = lambda m, v: np.where(m, v, dtype(0.0)).astype(dtype)  # noqa: E731
    return dict(
        m_v=bb(m_v), m_p=bb(m_p),
        m_sig=bb(m_p & (x < nx - 1) & (y < ny - 1)),
        c_pt=bb(sel(m_p, dtau_over_beta)),
        c_vx=bb(sel(mask_x, dtau)),
        a_vx=bb(np.where(mask_x, dtype(e.dampX), dtype(1.0)).astype(dtype)),
        c_vy=bb(sel(mask_y, dtau)),
        a_vy=bb(np.where(mask_y, dtype(e.dampY), dtype(1.0)).astype(dtype)),
        m_bx0=bb(mask_bcx & (y == 0)),
        m_bx1=bb(mask_bcx & (y == ny - 1)),
        m_by0=bb(mask_bcy & (x == 0)),
        m_by1=bb(mask_bcy & (x == nx - 1)),
    )


@transition_function
class FoldedPseudoTransientKernel:
    """The pseudo-transient iteration over :class:`FoldedConvectionCell`:
    the mathematics of :class:`PseudoTransientKernel`, bit for bit, with the
    coordinate masks read from the planes and the accumulate-style updates
    folded into coefficient-plane multiply-adds (``convection.cpp:76-183``).
    ``with_err=False`` drops the ErrV/ErrP bookkeeping, as in the straight
    kernel.

    The multiply-adds XLA fuses are the straight kernel's, with the
    coefficient planes in place of the masked scalars (found as there, by
    emulating the candidate forms in numpy against the JAX folded twin on
    ``reference``): ``Pt = fma(dV1, -c_pt, Pt)``; ``dV?d_tau = fma(dV?d_tau,
    a_v?, c_v?*R?)``; ``V? = fma(dV?d_tau, c_v?, V?)``. The three updates
    run on every cell (the planes make them the identity outside their
    region); the others keep the straight kernel's forms under the bool
    planes.
    """

    stencil_radius = 1
    n_subiterations = 3
    handles_boundary = True
    #: Operations per cell and iteration, the reference harness's count.
    n_operations = FLOPS_PER_CELL

    eta0: float = 0.0
    deltaT: float = 0.0
    delta_eta_delta_T: float = 0.0
    roh0_g_alpha: float = 0.0
    dx: float = 1.0
    dy: float = 1.0
    rho: float = 1.0
    with_err: bool = static_field(default=True)

    @property
    def dtype(self) -> torch.dtype:
        """The cell's dtype: that of the parameters."""
        return _param_dtype(self.dx)

    @property
    def cuda_op(self) -> str:
        """``convection_folded_pt[_lean]_{f32,f64}`` (``csrc/ops/convection.cuh``)."""
        width = "f64" if self.dtype == torch.float64 else "f32"
        return f"convection_folded_pt_{width}" if self.with_err else f"convection_folded_pt_lean_{width}"

    @property
    def cuda_variant(self) -> tuple:
        """Every physics field but T; lean also leaves ErrV and ErrP
        invariant."""
        return FIELDS[1:] if self.with_err else FIELDS[1:-2]

    @property
    def cuda_invariant_reads(self) -> tuple:
        """T and the planes; lean reads neither ErrV, ErrP nor ``m_v``."""
        return ("T", *PLANES) if self.with_err else ("T", *PLANES[1:])

    def get_time_dependent_value(self, i):
        return None

    def scalars(self) -> dict:
        """The scalar operands, each computed in the cell's dtype as JAX
        computes it on its traced scalars."""
        D = np.float64 if self.dtype == torch.float64 else np.float32
        one = D(1.0)
        return _scalars(
            self.dtype,
            inv_dx=one / D(self.dx), inv_dy=one / D(self.dy), third=D(1.0 / 3.0), dedT=D(self.delta_eta_delta_T),
            eta0=D(self.eta0), half_deltaT=D(self.deltaT) / D(2.0), inv_rho=one / D(self.rho),
            g=D(self.roh0_g_alpha),
        )

    def cuda_params(self) -> tuple:
        """The functor's parameters, in its order: :meth:`scalars`."""
        return tuple(self.scalars().values())

    def __call__(self, s):
        c = s[0, 0]
        _check_dtype(self, c.T)
        k = self.scalars()
        inv_dx, inv_dy = k["inv_dx"], k["inv_dy"]

        if s.subiteration == 0:
            upd = {}
            if self.with_err:
                upd["ErrV"] = torch.where(c.m_v, c.Vy, c.ErrV)
                upd["ErrP"] = torch.where(c.m_p, c.Pt, c.ErrP)
            d_xa_vx = s[1, 0].Vx - c.Vx
            d_ya_vy = s[0, 1].Vy - c.Vy
            ax, ay = d_xa_vx * inv_dx, d_ya_vy * inv_dy
            dV1 = fma(d_xa_vx, inv_dx, ay)
            dV2 = fma(d_ya_vy, inv_dy, ax)
            eta = k["eta0"] * fma(c.T + k["half_deltaT"], -k["dedT"], torch.ones_like(c.T))
            two_eta = 2.0 * eta
            upd["Pt"] = fma(dV1, -c.c_pt, c.Pt)
            upd["tau_xx"] = torch.where(c.m_p, two_eta * fma(dV2, -k["third"], ax), c.tau_xx)
            upd["tau_yy"] = torch.where(c.m_p, two_eta * fma(dV1, -k["third"], ay), c.tau_yy)
            d_yi_vx = s[1, 1].Vx - s[1, 0].Vx
            d_xi_vy = s[1, 1].Vy - s[0, 1].Vy
            upd["sigma_xy"] = torch.where(c.m_sig, eta * fma(d_xi_vy, inv_dx, d_yi_vx * inv_dy), c.sigma_xy)
            return dataclasses.replace(c, **upd)

        if s.subiteration == 1:
            sx = fma(s[-1, 0].sigma_xy - s[-1, -1].sigma_xy, inv_dy, (c.tau_xx - s[-1, 0].tau_xx) * inv_dx)
            Rx = k["inv_rho"] * fma(c.Pt - s[-1, 0].Pt, -inv_dx, sx)
            dVxd_tau = fma(c.dVxd_tau, c.a_vx, c.c_vx * Rx)
            Vx = fma(dVxd_tau, c.c_vx, c.Vx)
            sy = fma(s[0, -1].sigma_xy - s[-1, -1].sigma_xy, inv_dx, (c.tau_yy - s[0, -1].tau_yy) * inv_dy)
            sy = fma(c.Pt - s[0, -1].Pt, -inv_dy, sy)
            Ry = k["inv_rho"] * fma((s[0, -1].T + c.T) * 0.5, k["g"], sy)
            dVyd_tau = fma(c.dVyd_tau, c.a_vy, c.c_vy * Ry)
            Vy = fma(dVyd_tau, c.c_vy, c.Vy)
            return dataclasses.replace(c, dVxd_tau=dVxd_tau, Vx=Vx, dVyd_tau=dVyd_tau, Vy=Vy)

        # sub-iteration 2: boundary conditions + error update
        Vx = torch.where(c.m_bx0, s[0, 1].Vx, c.Vx)
        Vx = torch.where(c.m_bx1, s[0, -1].Vx, Vx)
        Vy = torch.where(c.m_by0, s[1, 0].Vy, c.Vy)
        Vy = torch.where(c.m_by1, s[-1, 0].Vy, Vy)
        upd = dict(Vx=Vx, Vy=Vy)
        if self.with_err:
            upd["ErrV"] = torch.where(c.m_v, c.ErrV - Vy, c.ErrV)
            upd["ErrP"] = torch.where(c.m_p, c.ErrP - c.Pt, c.ErrP)
        return dataclasses.replace(c, **upd)


# --------------------------------------------------------------------------- #
# Experiment configuration and the host convergence loop                      #
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class Experiment:
    """JSON experiment schema (``convection.cpp:305-333``); the reference's
    experiment files load unchanged."""

    lx: float
    ly: float
    px: float
    py: float
    eta0: float
    DcT: float
    deltaT: float
    Ra: float
    Pra: float
    res: int
    iterMax: int
    nt: int
    nout: int
    nerr: int
    epsilon: float
    dmp: float

    _INT_FIELDS = ("res", "iterMax", "nt", "nout", "nerr")

    @classmethod
    def load(cls, path) -> "Experiment":
        with open(path) as f:
            cfg = json.load(f)
        kwargs = {}
        for field in dataclasses.fields(cls):
            if field.name not in cfg:
                raise ValueError(f"experiment file is missing field '{field.name}'")
            v = cfg[field.name]
            kwargs[field.name] = int(v) if field.name in cls._INT_FIELDS else float(v)
        return cls(**kwargs)

    # Derived numerics (convection.cpp:317-355)
    @property
    def ar(self):
        return self.lx / self.ly

    @property
    def w_blob(self):
        return 1e-2 * self.ly

    @property
    def roh0_g_alpha(self):
        return self.Ra * self.eta0 * self.DcT / self.deltaT / self.ly**3

    @property
    def delta_eta_delta_T(self):
        return 1e-10 / self.deltaT

    @property
    def nx(self):
        return int(self.res * self.lx) - 1

    @property
    def ny(self):
        return int(self.res * self.ly) - 1

    @property
    def dx(self):
        return self.lx / (self.nx - 1)

    @property
    def dy(self):
        return self.ly / (self.ny - 1)

    @property
    def rho(self):
        return 1.0 / self.Pra * self.eta0 / self.DcT

    @property
    def dt_diff(self):
        return 1.0 / 4.1 * min(self.dx, self.dy) ** 2 / self.DcT

    @property
    def delta_tau_iter(self):
        return 1.0 / 6.1 * min(self.dx, self.dy) / math.sqrt(self.eta0 / self.rho)

    @property
    def beta(self):
        return 6.1 * self.delta_tau_iter**2 / min(self.dx, self.dy) ** 2 / self.rho

    @property
    def dampX(self):
        return 1.0 - self.dmp / self.nx

    @property
    def dampY(self):
        return 1.0 - self.dmp / self.ny


def make_pseudo_transient_kernel(e: Experiment, dtype=np.float32, with_err: bool = True) -> PseudoTransientKernel:
    """The pseudo-transient kernel of an experiment, its parameters in
    ``dtype`` (``np.float32`` or ``np.float64``), as the JAX package makes it."""
    f = lambda v: dtype(v)  # noqa: E731
    return PseudoTransientKernel(
        nx=e.nx, ny=e.ny,
        roh0_g_alpha=f(e.roh0_g_alpha),
        delta_eta_delta_T=f(e.delta_eta_delta_T),
        eta0=f(e.eta0), deltaT=f(e.deltaT),
        dx=f(e.dx), dy=f(e.dy),
        delta_tau_iter=f(e.delta_tau_iter), beta=f(e.beta), rho=f(e.rho),
        dampX=f(e.dampX), dampY=f(e.dampY), with_err=with_err,
    )


def make_thermal_kernel(e: Experiment, dtype=np.float32, dt: float = 0.0) -> ThermalSolverKernel:
    """The thermal kernel of an experiment, its parameters in ``dtype``."""
    return ThermalSolverKernel(
        nx=e.nx, ny=e.ny, dx=dtype(e.dx), dy=dtype(e.dy), dt=dtype(dt), DcT=dtype(e.DcT)
    )


def make_folded_pseudo_transient_kernel(
    e: Experiment, dtype=np.float32, with_err: bool = True
) -> FoldedPseudoTransientKernel:
    """The folded pseudo-transient kernel of an experiment, its parameters
    in ``dtype``, as the JAX package makes it."""
    f = lambda v: dtype(v)  # noqa: E731
    return FoldedPseudoTransientKernel(
        eta0=f(e.eta0), deltaT=f(e.deltaT), delta_eta_delta_T=f(e.delta_eta_delta_T),
        roh0_g_alpha=f(e.roh0_g_alpha), dx=f(e.dx), dy=f(e.dy), rho=f(e.rho), with_err=with_err,
    )


def init_folded_grid(e: Experiment, dtype=np.float32, *, device="cuda") -> Grid:
    """:func:`init_grid`'s initial condition with the coordinate planes
    (:func:`folded_planes`), on the card unless ``device`` says otherwise."""
    base = init_grid(e, dtype, device="cpu").to_numpy()
    planes = folded_planes(e, (e.nx + 1, e.ny + 1), dtype)
    return Grid.from_numpy(FoldedConvectionCell(**{f: getattr(base, f) for f in FIELDS}, **planes), device=device)


def init_grid(e: Experiment, dtype=np.float32, *, device="cuda") -> Grid:
    """Initial condition: hot bottom plate, cold top plate, Gaussian blob
    (``convection.cpp:380-397``), on the card unless ``device`` says
    otherwise."""
    nx, ny = e.nx, e.ny
    x = np.arange(nx + 1)[:, None]
    y = np.arange(ny + 1)[None, :]
    blob = e.deltaT * np.exp(
        -(((x * e.dx - e.px) / e.w_blob) ** 2) - ((y * e.dy - e.py) / e.w_blob) ** 2
    )
    T = np.where((x < nx) & (y < ny), blob, 0.0)
    T = np.where(y == ny - 1, -e.deltaT / 2.0, T)
    T = np.where(y == 0, e.deltaT / 2.0, T)
    zeros = np.zeros((nx + 1, ny + 1), dtype)
    fields = {f: zeros for f in FIELDS}
    fields["T"] = T.astype(dtype)
    return Grid.from_numpy(ThermalConvectionCell(**fields), device=device)


def _error_maxes(arrays: ThermalConvectionCell, nx: int, ny: int) -> list[float]:
    """Masked |max| reductions the reference scans on the host
    (``convection.cpp:412-436``): on the grid's device, brought to the host
    in one transfer."""
    return torch.stack([
        arrays.ErrV[:nx, :].abs().max(),
        arrays.ErrP[:nx, :ny].abs().max(),
        arrays.Vx[:, :ny].abs().max(),
        arrays.Vy[:nx, :ny].abs().max(),
        arrays.Pt[:nx, :ny].abs().max(),
    ]).tolist()


#: Counters of the timestep loop, kept as ``tdv.evaluations`` is: the
#: timesteps :meth:`Simulation.step` ran, its convergence blocks, and the
#: pseudo-transient iterations of those blocks (``nerr`` a block).
steps = 0
blocks = 0
pt_iterations = 0


class Simulation:
    """One timestep of the convection loop (``convection.cpp:399-478``) a
    call of :meth:`step`, through the port's entry point.

    The three updaters are made once (``pt_update``, ``lean_update``,
    ``thermal_update``, all on ``backend`` with ``backend_kwargs``). A step
    runs the convergence loop: blocks of ``nerr - 1`` lean iterations (no
    Err bookkeeping) and one full one, except on ``reference``, which runs
    ``nerr`` full ones (both give the same grid), each block followed by the
    five masked maxima read back to the host, until ``errV`` and ``errP``
    are both at most ``epsilon`` or ``iterMax`` is reached. Then the
    adaptive ``dt`` from the largest velocities, written into the thermal
    update's live parameter, and the thermal step. ``stats`` holds the last
    step's ``iters``, ``errV``, ``errP``, ``dt`` and ``pt_seconds`` (the
    convergence loop's host-clock time).

    ``folded=True`` runs :class:`FoldedPseudoTransientKernel` with the
    lean/full split on every backend (as the JAX package's folded path
    does); its fields equal the straight run's bit for bit. The thermal step
    runs the straight thermal kernel on the grid's 11 physics fields (the
    same tensors), which neither reads nor writes a folded grid's planes.
    """

    def __init__(self, e: Experiment, dtype=np.float32, folded: bool = False, backend: str = "auto",
                 **backend_kwargs):
        self.e = e
        self.dtype = dtype = np.dtype(dtype).type
        halo = folded_zero_cell() if folded else zero_cell()
        use_lean = e.nerr > 1 and (folded or backend != "reference")
        make_pt = make_folded_pseudo_transient_kernel if folded else make_pseudo_transient_kernel

        def update(tf, n, halo, **params):
            return create_update(
                Params(transition_function=tf, halo_value=halo, n_iterations=n, **params),
                backend=backend, **backend_kwargs,
            )

        self.pt_update = update(make_pt(e, dtype, with_err=True), 1 if use_lean else e.nerr, halo, blocking=True)
        self.lean_update = (
            update(make_pt(e, dtype, with_err=False), e.nerr - 1, halo, blocking=True) if use_lean else None
        )
        self.thermal_update = update(make_thermal_kernel(e, dtype), 1, zero_cell())
        self.stats = None

    def step(self, grid: Grid) -> Grid:
        """One timestep from ``grid``; the input grid is never modified."""
        global steps, blocks, pt_iterations
        e = self.e
        with tracing.span("models.step") if tracing.on else tracing.OFF:
            errV = errP = 2 * e.epsilon
            max_vals = (0.0,) * 5
            iters = 0
            t0 = time.perf_counter()
            while iters < e.iterMax and (errV > e.epsilon or errP > e.epsilon):
                with tracing.span("models.block") if tracing.on else tracing.OFF:
                    if self.lean_update is not None:
                        grid = self.lean_update(grid)
                    grid = self.pt_update(grid)
                iters += e.nerr
                blocks += 1
                pt_iterations += e.nerr
                with tracing.span("models.check") if tracing.on else tracing.OFF:
                    max_vals = _error_maxes(grid.arrays, e.nx, e.ny)
                max_ErrV, max_ErrP, _, max_Vy, max_Pt = max_vals
                errV = max_ErrV / (1e-12 + max_Vy)
                errP = max_ErrP / (1e-12 + max_Pt)
            pt_seconds = time.perf_counter() - t0

            with tracing.span("models.thermal") if tracing.on else tracing.OFF:
                _, _, max_Vx, max_Vy, _ = max_vals
                dt = min(e.dt_diff, min(e.dx / max(max_Vx, 1e-300), e.dy / max(max_Vy, 1e-300)) / 2.1)
                # A live parameter: the next launch reads it, nothing rebuilds
                # (convection.cpp:452-457 rebuilds the whole updater here instead).
                self.thermal_update.get_params().transition_function.dt = self.dtype(dt)
                # The thermal step reads and writes the 11 physics fields only, so a
                # folded grid's planes stay as they are.
                T = self.thermal_update(Grid(physics_cell(grid.arrays))).arrays.T
                grid = Grid(dataclasses.replace(grid.arrays, T=T))
            steps += 1
        self.stats = {"iters": iters, "errV": errV, "errP": errP, "dt": dt, "pt_seconds": pt_seconds}
        return grid


def run(
    e: Experiment,
    out_dir: str | None = None,
    backend: str = "auto",
    dtype=np.float32,
    verbose: bool = True,
    folded: bool = False,
    *,
    device="cuda",
    **backend_kwargs,
):
    """Full timestep loop with pseudo-transient convergence
    (``convection.cpp:399-478``) on ``device`` (the card unless it says
    otherwise): ``nt`` steps of a :class:`Simulation` from :func:`init_grid`
    (:func:`init_folded_grid` with ``folded=True``), printing each step and
    writing a CSV frame every ``nout`` steps into ``out_dir``. Returns
    ``(grid, info)``: ``info`` holds the per-timestep ``stats``, the
    ``total_time``, the pseudo-transient updates' walltime ``pt_walltime``
    (the "transient computation time") and the three updaters
    (``pt_update``, ``lean_update``, ``thermal_update``).
    ``backend_kwargs`` go to every updater (e.g. ``window_mode="linecache"``
    for ``tiling``). ``float64`` runs on the CUDA kernels like ``float32``;
    the JAX package runs float64 and ``reference`` straight, the port runs
    them folded too.
    """
    sim = Simulation(e, dtype, folded, backend, **backend_kwargs)
    grid = (init_folded_grid if folded else init_grid)(e, sim.dtype, device=device)

    stats = []
    start = time.perf_counter()
    for it in range(1, e.nt + 1):
        grid = sim.step(grid)
        s = sim.stats
        if verbose:
            print(
                f"it = {it} (iter = {s['iters']}, time = {s['pt_seconds']:e}), "
                f"errV={s['errV']:1.3e}, errP={s['errP']:1.3e}"
            )
        stats.append({"it": it, "iters": s["iters"], "errV": s["errV"], "errP": s["errP"], "dt": s["dt"]})

        if out_dir is not None and it % e.nout == 0:
            write_csv_frame(os.path.join(out_dir, f"{it}.csv"), grid.to_numpy().T[: e.nx, : e.ny])

    total = time.perf_counter() - start
    pt_update, lean_update = sim.pt_update, sim.lean_update
    pt_wall = pt_update.get_walltime() + (lean_update.get_walltime() if lean_update is not None else 0.0)
    if verbose:
        print(f"Total time = {total}")
        print(f"Of which transient computation time: {pt_wall} s")
    return grid, {
        "stats": stats, "total_time": total, "pt_walltime": pt_wall, "pt_update": pt_update,
        "lean_update": lean_update, "thermal_update": sim.thermal_update,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="convection", description="2D thermal mantle convection")
    parser.add_argument("experiment", help="path to experiment JSON")
    parser.add_argument("output_dir")
    parser.add_argument("--backend", default="auto")
    parser.add_argument("--dtype", default="float32", choices=["float32", "float64"])
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    parser.add_argument(
        "--folded", action="store_true",
        help="run the folded pseudo-transient kernel (coordinate masks stored as invariant planes)",
    )
    args = parser.parse_args(argv)

    if not os.path.isfile(args.experiment):
        print("The experiment file does not exist or is not a regular file.", file=sys.stderr)
        return 1
    if not os.path.isdir(args.output_dir):
        print("The output directory does not exist or is not a directory.", file=sys.stderr)
        return 1

    e = Experiment.load(args.experiment)
    run(e, out_dir=args.output_dir, backend=args.backend,
        dtype=np.float64 if args.dtype == "float64" else np.float32, folded=args.folded,
        device=torch.device(args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
