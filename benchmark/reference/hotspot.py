"""Plain PyTorch reference of Rodinia HotSpot, as StencilStream's
``examples/hotspot/hotspot.cpp`` states it.

It imports nothing of the port and takes nothing the port made: the
coefficients are derived here again from the configuration's constants
(``hotspot.cpp:281-295``), rounded to float32 as upstream stores them, and
the update is Rodinia's formula (``hotspot.cpp:77-92``) with each missing
edge neighbour replaced by the centre temperature::

    new = old + Cap_1 * (power + (bottom + top - 2 old) Ry_1
                         + (right + left - 2 old) Rx_1 + (amb - old) Rz_1)

Every operation runs in ``dtype``: float64 for the comparison, bfloat16 for
the control.
"""

from __future__ import annotations

import numpy as np
import torch


def coefficients(config: dict, height: int, width: int) -> dict[str, float]:
    """``Rx_1``, ``Ry_1``, ``Rz_1``, ``Cap_1`` and the ambient temperature,
    each rounded to float32."""
    k = config["constants"]
    grid_height = k["chip_height"] / height
    grid_width = k["chip_width"] / width
    cap = k["factor_chip"] * k["spec_heat_si"] * k["t_chip"] * grid_height * grid_width
    rx = grid_width / (2.0 * k["k_si"] * k["t_chip"] * grid_height)
    ry = grid_height / (2.0 * k["k_si"] * k["t_chip"] * grid_width)
    rz = k["t_chip"] / (k["k_si"] * grid_height * grid_width)
    max_slope = k["max_pd"] / (k["factor_chip"] * k["t_chip"] * k["spec_heat_si"])
    step = k["precision"] / max_slope / 1000.0
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    return {"Rx_1": f32(1.0 / rx), "Ry_1": f32(1.0 / ry), "Rz_1": f32(1.0 / rz),
            "Cap_1": f32(step / cap), "amb": f32(k["amb_temp"])}


def run(fields: dict[str, torch.Tensor], n: int, config: dict, dtype=torch.float64) -> dict[str, torch.Tensor]:
    """``n`` iterations from ``fields`` (``temp``, ``power``), in ``dtype``."""
    temp = fields["temp"].to(dtype, copy=True)
    power = fields["power"].to(dtype, copy=True)
    c = coefficients(config, *temp.shape)
    for _ in range(n):
        dy = torch.zeros_like(temp)
        dy[1:] += temp[:-1] - temp[1:]  # top - old; the top row's top is itself
        dy[:-1] += temp[1:] - temp[:-1]  # bottom - old
        dx = torch.zeros_like(temp)
        dx[:, 1:] += temp[:, :-1] - temp[:, 1:]  # left - old
        dx[:, :-1] += temp[:, 1:] - temp[:, :-1]  # right - old
        delta = power + dy * c["Ry_1"] + dx * c["Rx_1"] + (c["amb"] - temp) * c["Rz_1"]
        temp = temp + delta * c["Cap_1"]
    return {"temp": temp, "power": power}
