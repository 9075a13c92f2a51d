"""Plain PyTorch reference of StencilStream's FDTD disk cavity with the
coefficients stored in every cell (``examples/fdtd``), as its sources state
it.

It imports nothing of the port: the time step, the source's cell, the
cutoff and detect iterations and the ring's coefficients are derived here
from the configuration's published constants (``Parameters.hpp:216-251``;
the coefficient formulas of the coefficient resolver). Iteration ``i``
(absolute: the offset the state carries plus the step) is two sub-steps
over the whole grid, with the halo 0 beyond it::

    E:  ex = ex ca + cb (hz - hz[r, c-1])
        ey = ey ca + cb (hz[r-1, c] - hz)
    H:  hz = hz da + db (ex[r, c+1] - ex + ey - ey[r+1, c])
        hz[source] += cos(w t) exp(-((t - t0) / tau)^2),  t = i dt,  while i <= cutoff
        hz_sum += hz^2                                      while i > detect

The coefficients ``ca, cb, da, db`` are the cell's invariant fields. :func:`run`
derives them for the grid from the configuration (:func:`material_planes`),
whatever planes the state it is given holds, and returns them: a coefficient
the program initialised or overwrote wrongly differs from them, and its
fields follow. A test that wants other coefficients passes them. Where it
departs from upstream:

* every operation runs in ``dtype`` (float64 for the comparison, bfloat16
  for the control), with no fused multiply-add;
* the source amplitude is evaluated in float64 from the float32 time step
  (upstream: in float32), then rounded to ``dtype``;
* cells beyond the ring hold zero coefficients (the coefficient resolver's
  cell outside every ring), which zero their fields;
* only a point source (radius 0), the configuration's, is modelled;
* on a test grid that is not the configuration's, the ring follows the
  grid-scaling rule for the shorter side ``S`` and fills the top-left ``S x
  S`` square; the source sits at its centre;
* the state carries the benchmark's ``iteration`` plane: the absolute
  iteration its next call starts at, returned advanced by ``n`` and held in
  float64 whatever ``dtype`` (it is a count, not a result).
"""

from __future__ import annotations

import math

import numpy as np
import torch

C0 = 299792458.0
MU_0 = 4.0e-7 * math.pi
EPS_0 = 1.0 / (C0 * C0 * MU_0)
VARIANT = ("ex", "ey", "hz", "hz_sum")
COEFFICIENTS = ("ca", "cb", "da", "db")


def constants(config: dict, height: int, width: int) -> dict:
    """The time axis, the source cell and the ring's coefficients of the
    configuration's experiment on a ``height x width`` grid."""
    e = config["experiment"]
    if e["source"]["radius"] != 0.0 or len(e["cavity_rings"]) != 1:
        raise ValueError("the reference models a point source and one ring")
    tau, dx = e["tau"], e["dx"]
    # Parameters.hpp: dt = dx / (C0 sqrt 2) * 0.99, in float32
    dt = float(np.float32(dx) / np.float32(C0 * math.sqrt(2.0)) * np.float32(0.99))
    side = min(height, width)  # the square the ring fills
    ring = e["cavity_rings"][0]
    sigma = ring["sigma"]
    f32 = lambda v: float(np.float32(v))  # noqa: E731  upstream stores the coefficients as float
    return {
        "dt": dt,
        "tau": tau,
        "t0": e["source"]["phase"] * tau,
        "omega": 2.0 * math.pi * e["source"]["frequency"],
        "cutoff": math.floor(e["time"]["t_cutoff"] * tau / dt),
        "detect": math.floor(e["time"]["t_detect"] * tau / dt),
        "n_snap": math.ceil(e["time"]["t_snap"] * tau / dt),
        "source": (int(side // 2 + e["source"]["y"] / dx), int(side // 2 + e["source"]["x"] / dx)),
        "side": side,
        "radius": (side - 2.5) / 2.0 * dx,
        "ca": f32((1.0 - sigma * dt) / (1.0 + sigma * dt)),
        "cb": f32((dt / (EPS_0 * ring["eps_r"] * dx)) / (1.0 + sigma * dt / (2.0 * EPS_0 * ring["eps_r"]))),
        "da": f32((1.0 - sigma * dt) / (1.0 + sigma * dt)),
        "db": f32((dt / (MU_0 * ring["mu_r"] * dx)) / (1.0 + sigma * dt / (2.0 * MU_0 * ring["mu_r"]))),
    }


def material_planes(config: dict, height: int, width: int) -> dict[str, torch.Tensor]:
    """``ca, cb, da, db`` of every cell, float32 on the CPU: the ring's inside
    the radius of the ring's square, measured from its centre in float32 as
    upstream's initialisation does, 0 elsewhere."""
    k = constants(config, height, width)
    side = k["side"]
    rr = np.arange(side, dtype=np.float32)[:, None] - np.float32(side) / np.float32(2.0)
    cc = np.arange(side, dtype=np.float32)[None, :] - np.float32(side) / np.float32(2.0)
    distance = np.float32(config["experiment"]["dx"]) * np.sqrt(rr * rr + cc * cc)
    inside = torch.from_numpy(distance < np.float32(k["radius"]))
    planes = {}
    for name in COEFFICIENTS:
        plane = torch.zeros(height, width, dtype=torch.float32)
        plane[:side, :side] = torch.where(inside, k[name], 0.0)
        planes[name] = plane
    return planes


def amplitudes(k: dict, offset: int, n: int, device) -> torch.Tensor:
    """The source amplitude of iterations ``offset .. offset + n - 1``, float64."""
    t = torch.arange(offset, offset + n, dtype=torch.float64, device=device) * k["dt"]
    progress = (t - k["t0"]) / k["tau"]
    return torch.cos(k["omega"] * t) * torch.exp(-progress * progress)


def run(fields: dict[str, torch.Tensor], n: int, config: dict, dtype=torch.float64,
        coefficients: dict[str, torch.Tensor] | None = None) -> dict[str, torch.Tensor]:
    """``n`` iterations from the variant fields and the ``iteration`` plane of
    ``fields``, in ``dtype``, with the coefficients of :func:`material_planes`
    (or ``coefficients``, where given); the state's own coefficient planes are
    not read."""
    offset = int(fields["iteration"].reshape(-1)[0])
    k = constants(config, *fields["ex"].shape)
    ex, ey, hz, hz_sum = (fields[f].to(dtype, copy=True) for f in VARIANT)
    if coefficients is None:
        coefficients = material_planes(config, *fields["ex"].shape)
    ca, cb, da, db = (coefficients[f].to(ex.device, dtype, copy=True) for f in COEFFICIENTS)
    amp = amplitudes(k, offset, n, ex.device).to(dtype)
    sources = k["cutoff"] + 1 - offset  # the steps before it have an iteration <= cutoff
    first_detect = k["detect"] + 1 - offset  # the first step whose iteration is > detect
    sr, sc = k["source"]
    d = torch.empty_like(hz)
    for step in range(n):
        torch.sub(hz[:, 1:], hz[:, :-1], out=d[:, 1:])
        d[:, 0] = hz[:, 0]
        ex.mul_(ca).addcmul_(cb, d)
        torch.sub(hz[:-1], hz[1:], out=d[1:])
        torch.neg(hz[0], out=d[0])
        ey.mul_(ca).addcmul_(cb, d)
        torch.sub(ey, ex, out=d)
        d[:, :-1] += ex[:, 1:]
        d[:-1] -= ey[1:]
        hz.mul_(da).addcmul_(db, d)
        if step < sources:
            hz[sr, sc] += amp[step]
        if step >= first_detect:
            hz_sum.addcmul_(hz, hz)
    out = {"ex": ex, "ey": ey, "hz": hz, "hz_sum": hz_sum, "ca": ca, "cb": cb, "da": da, "db": db}
    out["iteration"] = torch.full_like(fields["iteration"], offset + n, dtype=torch.float64)
    return out
