"""Plain PyTorch reference of StencilStream's Jacobi5General
(``examples/jacobi/kernels.hpp``): each cell becomes the weighted sum of
itself and its four neighbours, with the constant halo outside the grid.

It imports nothing of the port. The coefficients are the configuration's,
rounded to float32 as upstream stores them; every operation runs in
``dtype``: float64 for the comparison, bfloat16 for the control.
"""

from __future__ import annotations

import numpy as np
import torch


def run(fields: dict[str, torch.Tensor], n: int, config: dict, dtype=torch.float64) -> dict[str, torch.Tensor]:
    """``n`` iterations from ``fields`` (``value``), in ``dtype``."""
    c = {k: float(np.float32(v)) for k, v in config["coefficients"].items()}
    halo = float(np.float32(config["halo_value"]["value"]))
    v = fields["value"].to(dtype, copy=True)
    for _ in range(n):
        acc = v * c["center"]
        acc[1:] += v[:-1] * c["up"]
        acc[:-1] += v[1:] * c["down"]
        acc[:, 1:] += v[:, :-1] * c["left"]
        acc[:, :-1] += v[:, 1:] * c["right"]
        if halo:
            acc[0] += halo * c["up"]
            acc[-1] += halo * c["down"]
            acc[:, 0] += halo * c["left"]
            acc[:, -1] += halo * c["right"]
        v = acc
    return {"value": v}
