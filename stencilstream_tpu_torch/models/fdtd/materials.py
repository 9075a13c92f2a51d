"""FDTD material system on the PyTorch/CUDA port: relative materials, update
coefficients, and the three material-resolver policies.

Counterpart of ``stencilstream_tpu/models/fdtd/materials.py``:

* :class:`RelMaterial` / :class:`CoefMaterial` — relative permeability,
  permittivity and conductivity, and the E/H update coefficients derived
  from them in float32;
* :class:`CoefResolver` — coefficients stored per cell (:class:`CoefCell`);
* :class:`LUTResolver` — an int32 ring index per cell and a 16-entry
  coefficient table (:class:`LUTCell`);
* :class:`RenderResolver` — the ring rendered from the cell's radial
  position at update time, nothing stored (:class:`RenderCell`).

Each resolver declares its cell type, its table state (numpy float32
arrays, ``None`` for ``coef``) and ``coefficients(state, center_cell,
distance_score) -> CoefMaterial`` over whole tensors. It also names the
device functor of ``csrc/ops/fdtd.cuh`` that resolves the same way
(``cuda_op``) and the table values that functor takes (``cuda_params``).
A resolver built without parameters carries no table of its own: its
methods read the state they are given, which is how
:mod:`stencilstream_tpu_torch.interop` carries a JAX kernel's state across.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ...core import cell_type
from .params import MAX_N_RINGS, C0, Parameters

__all__ = [
    "RelMaterial",
    "CoefMaterial",
    "CoefCell",
    "LUTCell",
    "RenderCell",
    "CoefResolver",
    "LUTResolver",
    "RenderResolver",
    "RESOLVERS",
]

MU_0 = 4.0 * math.pi * 1.0e-7
EPS_0 = 1.0 / (C0 * C0 * MU_0)
#: Entries of the coefficient table: the rings and perfect metal beyond.
N_TABLE = MAX_N_RINGS + 1
COEFFICIENTS = ("ca", "cb", "da", "db")


@dataclasses.dataclass
class RelMaterial:
    """Material in terms of relative permeability/permittivity/conductivity."""

    mu_r: float
    eps_r: float
    sigma: float

    @classmethod
    def perfect_metal(cls) -> "RelMaterial":
        return cls(mu_r=math.inf, eps_r=math.inf, sigma=0.0)

    # Coefficient derivations, float32 like the JAX package's.
    def ca(self, dx: float, dt: float) -> float:
        return float(np.float32((1 - self.sigma * dt) / (1 + self.sigma * dt)))

    def cb(self, dx: float, dt: float) -> float:
        if math.isinf(self.eps_r):
            return 0.0
        return float(
            np.float32(
                (dt / (EPS_0 * self.eps_r * dx))
                / (1 + (self.sigma * dt) / (2 * EPS_0 * self.eps_r))
            )
        )

    def da(self, dx: float, dt: float) -> float:
        return self.ca(dx, dt)

    def db(self, dx: float, dt: float) -> float:
        if math.isinf(self.mu_r):
            return 0.0
        return float(
            np.float32(
                (dt / (MU_0 * self.mu_r * dx))
                / (1 + (self.sigma * dt) / (2 * MU_0 * self.mu_r))
            )
        )


@dataclasses.dataclass
class CoefMaterial:
    """E/H update coefficients; fields may be scalars or elementwise tensors."""

    ca: object
    cb: object
    da: object
    db: object

    @classmethod
    def perfect_metal(cls) -> "CoefMaterial":
        return cls(ca=1.0, cb=0.0, da=1.0, db=0.0)

    @classmethod
    def from_relative(cls, m: RelMaterial, dx: float, dt: float) -> "CoefMaterial":
        return cls(ca=m.ca(dx, dt), cb=m.cb(dx, dt), da=m.da(dx, dt), db=m.db(dx, dt))


def _ring_materials(parameters: Parameters) -> list[CoefMaterial]:
    """Coefficient table indexed by ring, padded to MAX_N_RINGS+1 entries
    with perfect metal."""
    dx, dt = parameters.dx, parameters.dt()
    table = []
    for i in range(N_TABLE):
        if i < len(parameters.rings):
            ring = parameters.rings[i]
            table.append(
                CoefMaterial.from_relative(RelMaterial(ring.mu_r, ring.eps_r, ring.sigma), dx, dt)
            )
        else:
            table.append(CoefMaterial.perfect_metal())
    return table


def _lut(parameters: Parameters) -> dict:
    table = _ring_materials(parameters)
    return {f: np.asarray([getattr(m, f) for m in table], np.float32) for f in COEFFICIENTS}


def _table_params(state: dict) -> tuple:
    """The table as a functor takes it: ca[16], cb[16], da[16], db[16]."""
    return tuple(float(v) for f in COEFFICIENTS for v in state[f])


def _gather(state: dict, index: torch.Tensor) -> CoefMaterial:
    """The table's entries at ``index`` (int tensor, values in range). A
    table given as a tensor is gathered from as it is, so that a gradient
    reaches it through the ``reference`` backend."""
    index = index.long()
    tables = {
        f: state[f].to(index.device) if isinstance(state[f], torch.Tensor)
        else torch.tensor(state[f], device=index.device)
        for f in COEFFICIENTS
    }
    return CoefMaterial(**{f: t[index] for f, t in tables.items()})


# --------------------------------------------------------------------------- #
# CoefResolver                                                                #
# --------------------------------------------------------------------------- #
@cell_type
class CoefCell:
    ex: torch.Tensor
    ey: torch.Tensor
    hz: torch.Tensor
    hz_sum: torch.Tensor
    ca: torch.Tensor
    cb: torch.Tensor
    da: torch.Tensor
    db: torch.Tensor


class CoefResolver:
    """Material coefficients stored in every cell; on the card they are the
    functor's four invariant fields."""

    name = "coef"
    MaterialCell = CoefCell
    cuda_op = "fdtd_coef"

    def __init__(self, parameters: Parameters | None = None):
        self._table = _ring_materials(parameters) if parameters is not None else None

    @staticmethod
    def halo_cell() -> CoefCell:
        return CoefCell(ex=0.0, ey=0.0, hz=0.0, hz_sum=0.0, ca=0.0, cb=0.0, da=0.0, db=0.0)

    def cell_from_parameters(self, parameters: Parameters, ring_index: int) -> CoefCell:
        z = np.float32(0.0)
        if ring_index >= len(parameters.rings):
            return CoefCell(ex=z, ey=z, hz=z, hz_sum=z, ca=z, cb=z, da=z, db=z)
        m = self._table[ring_index]
        return CoefCell(
            ex=z, ey=z, hz=z, hz_sum=z,
            ca=np.float32(m.ca), cb=np.float32(m.cb), da=np.float32(m.da), db=np.float32(m.db),
        )

    def kernel_state(self):
        return None

    @staticmethod
    def coefficients(state, center_cell, distance_score) -> CoefMaterial:
        return CoefMaterial(ca=center_cell.ca, cb=center_cell.cb, da=center_cell.da, db=center_cell.db)

    @staticmethod
    def cuda_params(state) -> tuple:
        return ()


# --------------------------------------------------------------------------- #
# LUTResolver                                                                 #
# --------------------------------------------------------------------------- #
@cell_type
class LUTCell:
    ex: torch.Tensor
    ey: torch.Tensor
    hz: torch.Tensor
    hz_sum: torch.Tensor
    index: torch.Tensor  # int32 ring index


class LUTResolver:
    """Ring index stored per cell; coefficients looked up in a 16-entry
    table (0 for an index outside it, as the JAX package's select chain
    gives). On the card the index is the functor's one invariant field,
    whose int32 bits the kernels carry in a float32 plane."""

    name = "lut"
    MaterialCell = LUTCell
    cuda_op = "fdtd_lut"

    def __init__(self, parameters: Parameters | None = None):
        self._lut = _lut(parameters) if parameters is not None else None

    @staticmethod
    def halo_cell() -> LUTCell:
        return LUTCell(ex=0.0, ey=0.0, hz=0.0, hz_sum=0.0, index=0)

    def cell_from_parameters(self, parameters: Parameters, ring_index: int) -> LUTCell:
        z = np.float32(0.0)
        return LUTCell(ex=z, ey=z, hz=z, hz_sum=z, index=np.int32(ring_index))

    def kernel_state(self) -> dict:
        return dict(self._lut)

    @staticmethod
    def coefficients(state, center_cell, distance_score) -> CoefMaterial:
        index = center_cell.index
        inside = (index >= 0) & (index < N_TABLE)
        mat = _gather(state, index.clamp(0, N_TABLE - 1))
        return CoefMaterial(**{f: torch.where(inside, getattr(mat, f), 0.0) for f in COEFFICIENTS})

    @staticmethod
    def cuda_params(state) -> tuple:
        return _table_params(state)


# --------------------------------------------------------------------------- #
# RenderResolver                                                              #
# --------------------------------------------------------------------------- #
@cell_type
class RenderCell:
    ex: torch.Tensor
    ey: torch.Tensor
    hz: torch.Tensor
    hz_sum: torch.Tensor


class RenderResolver:
    """Material rendered from the cell's radial position at update time:
    the innermost ring whose distance bound covers the cell's score (the
    table's last entry when none does); cells carry only field values."""

    name = "render"
    MaterialCell = RenderCell
    cuda_op = "fdtd_render"

    def __init__(self, parameters: Parameters | None = None):
        self._state = None
        if parameters is not None:
            dx = parameters.dx
            center_r = float(parameters.grid_range()[0] // 2)
            bounds = []
            radius = 0.0
            for i in range(N_TABLE):
                if i < len(parameters.rings):
                    radius += parameters.rings[i].radius
                    bounds.append((radius / dx) * (radius / dx) - 2 * center_r * center_r)
                else:
                    bounds.append(math.inf)
            self._state = {"bounds": np.asarray(bounds, np.float32), **_lut(parameters)}

    @staticmethod
    def halo_cell() -> RenderCell:
        return RenderCell(ex=0.0, ey=0.0, hz=0.0, hz_sum=0.0)

    def cell_from_parameters(self, parameters: Parameters, ring_index: int) -> RenderCell:
        z = np.float32(0.0)
        return RenderCell(ex=z, ey=z, hz=z, hz_sum=z)

    def kernel_state(self) -> dict:
        return dict(self._state)

    @staticmethod
    def coefficients(state, center_cell, distance_score) -> CoefMaterial:
        ring = torch.full_like(distance_score, N_TABLE - 1, dtype=torch.int32)
        for i in range(N_TABLE - 1, -1, -1):
            ring = torch.where(distance_score <= float(state["bounds"][i]), i, ring)
        return _gather(state, ring)

    @staticmethod
    def cuda_params(state) -> tuple:
        return _table_params(state) + tuple(float(b) for b in state["bounds"])


RESOLVERS = {
    "coef": CoefResolver,
    "lut": LUTResolver,
    "render": RenderResolver,
}
