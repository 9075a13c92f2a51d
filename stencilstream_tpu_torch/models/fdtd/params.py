"""FDTD experiment parameters — JSON schema and derived quantities.

The port's own copy of ``stencilstream_tpu/models/fdtd/params.py`` (pure
Python and numpy): the same schema (tau, dx, time.{t_cutoff, t_detect,
t_max, t_snap?}, source.{frequency, phase, x, y, radius},
cavity_rings[].{radius, mu_r, eps_r, sigma}), the same physical constants
and ring-count limit, the same :class:`ConfigError` messages, and the same
derived quantities, computed in float32 where the JAX package does so, so
that both packages build the same grids and kernel constants from one
experiment file.
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys
from typing import IO, Optional

import numpy as np

__all__ = ["C0", "SQRT_2", "PI", "MAX_N_RINGS", "ConfigError", "RingParameter", "Parameters"]

C0 = 299792458.0  # speed of light, m/s
SQRT_2 = 1.4142135623730951
PI = 3.1415926535897932384626433
MAX_N_RINGS = 15


class ConfigError(ValueError):
    pass


def _checked_number(obj: dict, key: str, where: str = "") -> float:
    if key not in obj:
        raise ConfigError(f"Field '{key}' is missing!")
    v = obj[key]
    if not isinstance(v, (int, float)) or isinstance(v, bool):
        raise ConfigError(f"Field '{key}' has to be a number, but is a {type(v).__name__}!")
    return float(v)


@dataclasses.dataclass
class RingParameter:
    radius: float
    mu_r: float
    eps_r: float
    sigma: float

    @classmethod
    def from_json(cls, obj: dict) -> "RingParameter":
        radius = _checked_number(obj, "radius")
        if radius < 0.0:
            raise ConfigError("Invalid config file: Cavity ring radius may not be negative!")
        return cls(
            radius=radius,
            mu_r=_checked_number(obj, "mu_r"),
            eps_r=_checked_number(obj, "eps_r"),
            sigma=_checked_number(obj, "sigma"),
        )


@dataclasses.dataclass
class Parameters:
    tau: float = 100e-15
    dx: float = 10e-9
    t_cutoff_factor: float = 7.0
    t_detect_factor: float = 14.0
    t_max_factor: float = 15.0
    t_snap_factor: Optional[float] = None
    frequency: float = 120e12
    t_0_factor: float = 3.0
    source_x: float = 0.0
    source_y: float = 0.0
    source_radius: float = 0.0
    rings: list = dataclasses.field(default_factory=list)
    out_dir: str = "."

    # -- loading -------------------------------------------------------------
    @classmethod
    def from_json(cls, config: dict, out_dir: str = ".") -> "Parameters":
        def checked_object(obj, key):
            if key not in obj:
                raise ConfigError(f"Field '{key}' is missing!")
            if not isinstance(obj[key], dict):
                raise ConfigError(
                    f"Field '{key}' has to be an object, but is a {type(obj[key]).__name__}!"
                )
            return obj[key]

        time = checked_object(config, "time")
        source = checked_object(config, "source")
        rings_arr = config.get("cavity_rings")
        if rings_arr is None:
            raise ConfigError("Field 'cavity_rings' is missing!")
        if not isinstance(rings_arr, list):
            raise ConfigError(
                f"Field 'cavity_rings' has to be an array, but is a {type(rings_arr).__name__}!"
            )
        if len(rings_arr) > MAX_N_RINGS:
            raise ConfigError(
                f"Illegal config file: Too many rings. This build only supports up to {MAX_N_RINGS}"
            )

        return cls(
            tau=_checked_number(config, "tau"),
            dx=_checked_number(config, "dx"),
            t_cutoff_factor=_checked_number(time, "t_cutoff"),
            t_detect_factor=_checked_number(time, "t_detect"),
            t_max_factor=_checked_number(time, "t_max"),
            t_snap_factor=(
                _checked_number(time, "t_snap") if "t_snap" in time else None
            ),
            frequency=_checked_number(source, "frequency"),
            t_0_factor=_checked_number(source, "phase"),
            source_x=_checked_number(source, "x"),
            source_y=_checked_number(source, "y"),
            source_radius=_checked_number(source, "radius"),
            rings=[RingParameter.from_json(r) for r in rings_arr],
            out_dir=out_dir,
        )

    @classmethod
    def load(cls, path_or_stream, out_dir: str = ".") -> "Parameters":
        if hasattr(path_or_stream, "read"):
            config = json.load(path_or_stream)
        elif path_or_stream == "-":
            config = json.load(sys.stdin)
        else:
            with open(path_or_stream) as f:
                config = json.load(f)
        return cls.from_json(config, out_dir=out_dir)

    # -- derived quantities (Parameters.hpp:216-251) -------------------------
    def t_cutoff(self) -> float:
        return self.t_cutoff_factor * self.tau

    def t_detect(self) -> float:
        return self.t_detect_factor * self.tau

    def t_max(self) -> float:
        return self.t_max_factor * self.tau

    def t_0(self) -> float:
        return self.t_0_factor * self.tau

    def dt(self) -> float:
        # float32 arithmetic like the reference (Parameters.hpp:228)
        return float(np.float32(self.dx) / np.float32(C0 * SQRT_2) * np.float32(0.99))

    def n_timesteps(self) -> int:
        return int(math.ceil(self.t_max() / self.dt()))

    def n_snap_timesteps(self) -> Optional[int]:
        if self.t_snap_factor is None:
            return None
        return int(math.ceil((self.t_snap_factor * self.tau) / self.dt()))

    def omega(self) -> float:
        return 2.0 * PI * self.frequency

    def grid_range(self) -> tuple[int, int]:
        outer_radius = sum(r.radius for r in self.rings)
        width = int(math.ceil((2 * outer_radius / self.dx) + 2))
        return (width, width)

    def source_r(self) -> int:
        return int(float(self.grid_range()[0] // 2) + self.source_y / self.dx)

    def source_c(self) -> int:
        return int(float(self.grid_range()[0] // 2) + self.source_x / self.dx)

    def print_configuration(self, file: IO[str] = sys.stdout) -> None:
        p = lambda *a: print(*a, file=file)
        p("Simulation Configuration:\n")
        p("# Timing")
        p(f"tau               = {self.tau} s")
        p(f"t_cutoff          = {self.t_cutoff_factor} tau = {self.t_cutoff()} s")
        p(f"t_detect          = {self.t_detect_factor} tau = {self.t_detect()} s")
        p(f"t_max             = {self.t_max_factor} tau = {self.t_max()} s\n")
        p("# Source Wave")
        p(f"phase             = {self.t_0_factor} tau = {self.t_0()} s")
        p(f"frequency         = {self.frequency} Hz\n")
        p("# Cavity")
        inner = 0.0
        for i, ring in enumerate(self.rings):
            p(f"## Ring No. {i}")
            p(f"distance range    = [{inner}, {inner + ring.radius}]")
            inner += ring.radius
            p(f"mu_r              = {ring.mu_r}")
            p(f"eps_r             = {ring.eps_r}")
            p(f"sigma             = {ring.sigma}\n")
        p("# Execution parameters")
        p(f"dx                = {self.dx} m/cell")
        p(f"dt                = {self.dt()} s/iteration")
        p(f"grid w/h          = {self.grid_range()[0]} cells")
        p(f"n. timesteps      = {self.n_timesteps()}")
        if self.t_snap_factor is not None:
            p(f"n. snap timesteps = {self.n_snap_timesteps()}")
        p("")
