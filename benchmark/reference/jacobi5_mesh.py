"""Plain PyTorch reference of StencilStream's Jacobi5General
(``examples/jacobi/kernels.hpp``) for a grid held in blocks over cards:
each cell becomes the weighted sum of itself and its four neighbours, with
the constant halo outside the grid.

It imports nothing of the port. The coefficients are the configuration's,
rounded to float32 as upstream stores them; every operation runs in
``dtype``: float64 for the comparison, bfloat16 for the control. It computes
each iteration in bands of :data:`BAND_ROWS` rows into a second buffer, so
that besides the two buffers it holds only a band's temporaries: a block of
~21,000 x 81,920 cells in float64 takes two 13 GiB buffers. Each cell meets
the same operations in the same order as in ``reference/jacobi5.py``, so on
a whole grid the two agree bit for bit.

A block of a larger grid runs with ``origin``, its first row and column in
the grid, and ``extent``, the grid's size: the halo is added at the block's
edges that are the grid's. The update does not depend on where a cell lies,
so the origin only places the block, which must lie inside the extent; the
cells within ``n`` of an edge that is not the grid's are the caller's to
discard.
"""

from __future__ import annotations

import numpy as np
import torch

#: Rows of one band: a float64 band of 81,920 columns holds 1.3 GiB.
BAND_ROWS = 2048


def run(fields: dict[str, torch.Tensor], n: int, config: dict, dtype=torch.float64,
        origin: tuple[int, int] = (0, 0), extent: tuple[int, int] | None = None,
        band_rows: int = BAND_ROWS) -> dict[str, torch.Tensor]:
    """``n`` iterations from ``fields`` (``value``), in ``dtype``: the grid
    itself, or the block at ``origin`` of a grid of ``extent``."""
    c = {k: float(np.float32(v)) for k, v in config["coefficients"].items()}
    halo = float(np.float32(config["halo_value"]["value"]))
    v = fields["value"].to(dtype, copy=True)
    H, W = v.shape
    extent = (H, W) if extent is None else tuple(extent)
    if not (0 <= origin[0] and origin[0] + H <= extent[0] and 0 <= origin[1] and origin[1] + W <= extent[1]):
        raise ValueError(f"a {(H, W)} block at {tuple(origin)} does not lie in a {extent} grid")
    edges = {"up": origin[0] == 0, "down": origin[0] + H == extent[0],
             "left": origin[1] == 0, "right": origin[1] + W == extent[1]}
    new = torch.empty_like(v)
    for _ in range(n):
        for a in range(0, H, band_rows):
            b = min(a + band_rows, H)
            acc = new[a:b]
            torch.mul(v[a:b], c["center"], out=acc)
            lo, hi = max(a, 1), min(b, H - 1)  # the band's rows with an up, a down neighbour
            acc[lo - a:] += v[lo - 1:b - 1] * c["up"]
            acc[:hi - a] += v[a + 1:hi + 1] * c["down"]
            acc[:, 1:] += v[a:b, :-1] * c["left"]
            acc[:, :-1] += v[a:b, 1:] * c["right"]
            if halo:
                if edges["up"] and a == 0:
                    acc[0] += halo * c["up"]
                if edges["down"] and b == H:
                    acc[-1] += halo * c["down"]
                if edges["left"]:
                    acc[:, 0] += halo * c["left"]
                if edges["right"]:
                    acc[:, -1] += halo * c["right"]
        v, new = new, v
    return {"value": v}
