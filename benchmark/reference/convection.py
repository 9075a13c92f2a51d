"""Plain PyTorch reference of StencilStream's thermal convection
(``examples/convection``, a port of ParallelStencil.jl's
``ThermalConvection2D``), as its sources state it: the pseudo-transient
Stokes kernel (``convection.cpp:76-183``), the thermal kernel
(``:185-242``), the experiment's derived numbers (``:317-355``) and the
timestep loop (``:399-478``).

It imports nothing of the port. The grid is ``(nx + 1) x (ny + 1)`` cells,
``x`` the row and ``y`` the column, with the active region ``x < nx, y <
ny``; every tap that can lie outside the grid is guarded, so the halo never
reaches a cell. A pseudo-transient iteration is three sweeps over the whole
grid, each from the state the sweep before left::

    0:  divV = dxa(Vx)/dx + dya(Vy)/dy,  eta = eta0 (1 - dedT (T + deltaT/2))
        ErrV = Vy,  ErrP = Pt                            (the error snapshots)
        Pt -= dtau/beta divV,  tau_xx = 2 eta (dxa(Vx)/dx - divV/3),  tau_yy alike
        sigma_xy = eta (dxi(Vy)/dx + dyi(Vx)/dy)
    1:  Rx = (dxi(tau_xx)/dx + dya(sigma_xy)/dy - dxi(Pt)/dx) / rho
        Ry = (dyi(tau_yy)/dy + dxa(sigma_xy)/dx - dyi(Pt)/dy + rho0 g alpha avy(T)) / rho
        dV?d_tau = damp? dV?d_tau + R? dtau,  V? += dV?d_tau dtau
    2:  free-slip edges of Vx (first and last column) and Vy (first and last
        row);  ErrV -= Vy,  ErrP -= Pt

A timestep runs blocks of ``nerr`` iterations, after each the largest
``|ErrV|, |ErrP|, |Vx|, |Vy|, |Pt|`` over their regions, until ``errV =
max|ErrV| / (1e-12 + max|Vy|)`` and ``errP`` alike are both at most
``epsilon`` or ``iterMax`` iterations have run; then ``dt = min(dt_diff,
min(dx / max|Vx|, dy / max|Vy|) / 2.1)`` and one thermal step: upwind
advection and diffusion of ``T`` with ``dt``, then zero-flux rows.

Where it departs from upstream:

* every iteration writes the error fields, as upstream's kernel does; the
  port runs ``nerr - 1`` iterations without them and one with them, which
  gives the same grid;
* every operation runs in ``dtype`` (float64 for the comparison, bfloat16
  for the control) on whole arrays, a product and a sum apart where the
  port's kernels fuse them, and a quotient where they multiply by a
  reciprocal (the port keeps the JAX package's forms);
* the derived scalars and ``dt`` are Python floats (float64), whatever
  ``dtype``; the maxima are read back in ``dtype``;
* the grid's size sets ``nx`` and ``ny`` (upstream derives them from
  ``res``, ``lx`` and ``ly``; the two agree on a ``(3 res) x res`` grid);
* ``run`` takes ``n`` iterations as ``n / iterMax`` timesteps, or as one
  timestep capped at ``n`` where ``n < iterMax``, and keeps no output
  frames, statistics or timing.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FIELDS = ("T", "Pt", "Vx", "Vy", "tau_xx", "tau_yy", "sigma_xy", "dVxd_tau", "dVyd_tau", "ErrV", "ErrP")


def constants(config: dict, height: int, width: int) -> dict:
    """The experiment's derived numbers (``convection.cpp:317-355``) on a
    ``height x width`` grid: ``nx + 1 = height``, ``ny + 1 = width`` (``3
    res`` and ``res`` at ``lx 3, ly 1``), ``dx`` and ``dy`` from ``lx`` and
    ``ly``."""
    e = config["experiment"]
    nx, ny = height - 1, width - 1
    dx, dy = e["lx"] / (nx - 1), e["ly"] / (ny - 1)
    rho = 1.0 / e["Pra"] * e["eta0"] / e["DcT"]
    dtau = 1.0 / 6.1 * min(dx, dy) / math.sqrt(e["eta0"] / rho)
    return {
        "nx": nx, "ny": ny, "dx": dx, "dy": dy, "rho": rho, "dtau": dtau,
        "beta": 6.1 * dtau**2 / min(dx, dy) ** 2 / rho,
        "g": e["Ra"] * e["eta0"] * e["DcT"] / e["deltaT"] / e["ly"] ** 3,
        "dedT": 1e-10 / e["deltaT"],
        "dt_diff": 1.0 / 4.1 * min(dx, dy) ** 2 / e["DcT"],
        "dampX": 1.0 - e["dmp"] / nx, "dampY": 1.0 - e["dmp"] / ny,
    }


def _tap(a: torch.Tensor, dr: int, dc: int) -> torch.Tensor:
    """``a[x + dr, y + dc]`` at every cell, 0 beyond the grid."""
    H, W = a.shape
    return F.pad(a, (1, 1, 1, 1))[1 + dr:1 + dr + H, 1 + dc:1 + dc + W]


def _iteration(s: dict, k: dict, e: dict, m: dict) -> None:
    """One pseudo-transient iteration of ``s`` in place (its entries
    replaced)."""
    dx, dy = k["dx"], k["dy"]
    # sub-step 0
    Vx, Vy, Pt = s["Vx"], s["Vy"], s["Pt"]
    dxa_vx = (_tap(Vx, 1, 0) - Vx) / dx
    dya_vy = (_tap(Vy, 0, 1) - Vy) / dy
    divV = dxa_vx + dya_vy
    eta = e["eta0"] * (1.0 - k["dedT"] * (s["T"] + e["deltaT"] / 2.0))
    s["ErrV"] = torch.where(m["v"], Vy, s["ErrV"])
    s["ErrP"] = torch.where(m["p"], Pt, s["ErrP"])
    s["Pt"] = torch.where(m["p"], Pt - k["dtau"] / k["beta"] * divV, Pt)
    s["tau_xx"] = torch.where(m["p"], 2.0 * eta * (dxa_vx - divV / 3.0), s["tau_xx"])
    s["tau_yy"] = torch.where(m["p"], 2.0 * eta * (dya_vy - divV / 3.0), s["tau_yy"])
    dxi_vy = (_tap(Vy, 1, 1) - _tap(Vy, 0, 1)) / dx
    dyi_vx = (_tap(Vx, 1, 1) - _tap(Vx, 1, 0)) / dy
    s["sigma_xy"] = torch.where(m["sig"], eta * (dxi_vy + dyi_vx), s["sigma_xy"])
    # sub-step 1
    Pt, txx, tyy, sxy, T = s["Pt"], s["tau_xx"], s["tau_yy"], s["sigma_xy"], s["T"]
    Rx = ((txx - _tap(txx, -1, 0)) / dx + (_tap(sxy, -1, 0) - _tap(sxy, -1, -1)) / dy
          - (Pt - _tap(Pt, -1, 0)) / dx) / k["rho"]
    Ry = ((tyy - _tap(tyy, 0, -1)) / dy + (_tap(sxy, 0, -1) - _tap(sxy, -1, -1)) / dx
          - (Pt - _tap(Pt, 0, -1)) / dy + k["g"] * (_tap(T, 0, -1) + T) / 2.0) / k["rho"]
    s["dVxd_tau"] = torch.where(m["x"], k["dampX"] * s["dVxd_tau"] + Rx * k["dtau"], s["dVxd_tau"])
    s["Vx"] = torch.where(m["x"], s["Vx"] + s["dVxd_tau"] * k["dtau"], s["Vx"])
    s["dVyd_tau"] = torch.where(m["y"], k["dampY"] * s["dVyd_tau"] + Ry * k["dtau"], s["dVyd_tau"])
    s["Vy"] = torch.where(m["y"], s["Vy"] + s["dVyd_tau"] * k["dtau"], s["Vy"])
    # sub-step 2
    nx, ny = k["nx"], k["ny"]
    Vx, Vy = s["Vx"].clone(), s["Vy"].clone()
    Vx[:, 0], Vx[:, ny - 1] = s["Vx"][:, 1], s["Vx"][:, ny - 2]
    Vy[0, :], Vy[nx - 1, :] = s["Vy"][1, :], s["Vy"][nx - 2, :]
    s["Vx"], s["Vy"] = Vx, Vy
    s["ErrV"] = torch.where(m["v"], s["ErrV"] - Vy, s["ErrV"])
    s["ErrP"] = torch.where(m["p"], s["ErrP"] - s["Pt"], s["ErrP"])


def _thermal(s: dict, k: dict, e: dict, m: dict, dt: float) -> None:
    """One thermal step of ``s["T"]`` with ``dt``."""
    dx, dy = k["dx"], k["dy"]
    T, Vx, Vy = s["T"], s["Vx"], s["Vy"]
    T_xm, T_xp, T_ym, T_yp = _tap(T, -1, 0), _tap(T, 1, 0), _tap(T, 0, -1), _tap(T, 0, 1)
    qx_lo, qx_hi = -e["DcT"] * (T - T_xm) / dx, -e["DcT"] * (T_xp - T) / dx
    qy_lo, qy_hi = -e["DcT"] * (T - T_ym) / dy, -e["DcT"] * (T_yp - T) / dy
    dT_dt = -((qx_hi - qx_lo) / dx + (qy_hi - qy_lo) / dy)
    zero = torch.zeros((), dtype=T.dtype, device=T.device)
    Vx_p, Vy_p = _tap(Vx, 1, 0), _tap(Vy, 0, 1)
    dT_dt = dT_dt - torch.where(Vx > 0, Vx * (T - T_xm) / dx, zero)
    dT_dt = dT_dt - torch.where(Vx_p < 0, Vx_p * (T_xp - T) / dx, zero)
    dT_dt = dT_dt - torch.where(Vy > 0, Vy * (T - T_ym) / dy, zero)
    dT_dt = dT_dt - torch.where(Vy_p < 0, Vy_p * (T_yp - T) / dy, zero)
    T = torch.where(m["t"], T + dT_dt * dt, T)
    # zero flux across the first and last rows of the active region
    nx, ny = k["nx"], k["ny"]
    out = T.clone()
    out[nx - 1, :ny], out[0, :ny] = T[nx - 2, :ny], T[1, :ny]
    s["T"] = out


def _masks(k: dict, height: int, width: int, device) -> dict:
    nx, ny = k["nx"], k["ny"]
    x = torch.arange(height, device=device)[:, None]
    y = torch.arange(width, device=device)[None, :]
    p = (x < nx) & (y < ny)
    inner = (x >= 1) & (y >= 1)
    return {
        "p": p, "v": (x < nx) & (y < ny + 1), "sig": p & (x < nx - 1) & (y < ny - 1),
        "x": inner & (x < nx) & (y < ny - 1), "y": inner & (x < nx - 1) & (y < ny),
        "t": (x > 0) & (y > 0) & (x < nx - 1) & (y < ny - 1),
    }


def _maxima(s: dict, nx: int, ny: int) -> list[float]:
    """``max|ErrV|, max|ErrP|, max|Vx|, max|Vy|, max|Pt|`` over their regions."""
    return [float(a.abs().max()) for a in (s["ErrV"][:nx, :], s["ErrP"][:nx, :ny], s["Vx"][:, :ny],
                                           s["Vy"][:nx, :ny], s["Pt"][:nx, :ny])]


def run(fields: dict[str, torch.Tensor], n: int, config: dict, dtype=torch.float64) -> dict[str, torch.Tensor]:
    """``n / iterMax`` timesteps from ``fields`` (the 11 fields), each with
    the convergence rule and the adaptive ``dt``, in ``dtype``; ``n`` less
    than ``iterMax`` is one timestep capped at ``n`` (``iterMax = n``,
    ``nerr`` at most ``n``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    e = config["experiment"]
    if n < e["iterMax"]:
        e = dict(e, iterMax=n, nerr=min(e["nerr"], n))
    if n % e["iterMax"]:
        raise ValueError(f"{n} iterations are not whole timesteps of iterMax {e['iterMax']}")
    H, W = fields["T"].shape
    k = constants(config, H, W)
    m = _masks(k, H, W, fields["T"].device)
    s = {f: fields[f].to(dtype, copy=True) for f in FIELDS}
    for _ in range(n // e["iterMax"]):
        errV = errP = 2 * e["epsilon"]
        iters = 0
        maxima = [0.0] * 5
        while iters < e["iterMax"] and (errV > e["epsilon"] or errP > e["epsilon"]):
            for _ in range(e["nerr"]):
                _iteration(s, k, e, m)
            iters += e["nerr"]
            maxima = _maxima(s, k["nx"], k["ny"])
            errV = maxima[0] / (1e-12 + maxima[3])
            errP = maxima[1] / (1e-12 + maxima[4])
        dt = min(k["dt_diff"], min(k["dx"] / max(maxima[2], 1e-300), k["dy"] / max(maxima[3], 1e-300)) / 2.1)
        _thermal(s, k, e, m, dt)
    return s
