"""Distributed backend: the grid sharded over a 2D mesh of devices, halos
exchanged every pass.

Counterpart of ``stencilstream_tpu/backends/distributed.py``. The grid is
cut into one block per position of a ``("y", "x")`` mesh
(:mod:`..parallel`); every pass of ``p`` fused iterations first extends each
block with the ``r*p*k`` boundary rows and columns of its mesh neighbours
(:func:`..parallel.exchange_halo`, rows then columns, so corners arrive),
then computes the block's new core on the block's device:

* ``local_compute="kernel"`` (default; JAX's ``"pallas"``): the tile-pass
  kernel in extended mode (:func:`.tile_pass.tile_pass`), the block's
  global origin and the grid's extent passed in, on the device's current
  stream. On CPU devices it runs the kernel's plain version. A mesh axis of
  one position stores no halo: its blocks span the grid along it.
* ``local_compute="plain"`` (JAX's ``"xla"``): the plain cross-check path,
  :func:`.fused.fused_window_pass` shrinking both axes by the halo. Only an
  explicit argument selects it.

Fields the device functor only reads (those ``cuda_variant`` does not
name) are exchanged once a call: they never change. The grid is padded
(with the halo value; padded cells are out of the grid)
to a multiple of the mesh in each axis, and every block spans at least the
halo along a sharded axis, so the exchange is one hop. The result comes
back on the input grid's device. The JAX package's lane-aligned column halo
and sublane rounding are TPU layout rules, and its fallback to the
reference backend has no counterpart: a kernel that fails raises.
"""

from __future__ import annotations

import torch

from ..core.cell import cell_field_names, cell_leaves, cell_map, cell_unflatten
from ..core.grid import Grid
from ..parallel import Mesh, exchange_halo, make_mesh
from ..tdv import step_value, stream_to
from .base import StencilUpdateBase, resolve_halo
from .cuda_lib import device_limits, tile_cell_smem_bytes, tile_writes
from .fused import fused_window_pass, halo_width
from .tile_pass import tile_pass

__all__ = ["StencilUpdate", "pad_grid", "gather", "per_device"]


def pad_grid(arrays, halo_cell, rows: int, cols: int):
    """The cell's fields padded at the bottom and right to ``rows x cols``
    with the halo value."""
    def one(a, hv):
        H, W = a.shape
        if (H, W) == (rows, cols):
            return a
        out = torch.full((rows, cols), hv, dtype=a.dtype, device=a.device)
        out[:H, :W] = a
        return out

    return cell_map(one, arrays, halo_cell)


def gather(blocks, device, rows: int, cols: int):
    """One cell on ``device`` from a nested list of blocks (one list per
    mesh row), cut to ``rows x cols``."""
    leaves = [[cell_leaves(b) for b in row] for row in blocks]
    fields = []
    for j in range(len(leaves[0][0])):
        strips = [torch.cat([b[j].to(device) for b in row], dim=1) for row in leaves]
        fields.append(torch.cat(strips, dim=0)[:rows, :cols].contiguous())
    return cell_unflatten(blocks[0][0], fields)


def per_device(stream, devices) -> dict:
    """A call's TDV stream copied once to each device."""
    return {d: stream_to(stream, d) for d in devices}


class StencilUpdate(StencilUpdateBase):
    """Mesh-sharded stencil updater.

    Extra keyword options:

    * ``mesh`` — a :class:`..parallel.Mesh` with axes ``("y", "x")``
      (default: every visible CUDA device as a row mesh ``(n, 1)``; raises
      when there is none). Several positions may name one device.
    * ``iters_per_pass`` — p, iterations fused between halo exchanges; the
      halo is ``r * p * n_subiterations`` per side.
    * ``local_compute`` — ``"kernel"`` (default) or ``"plain"``.

    ``resolved_config`` holds the configuration the last call executed.
    """

    def __init__(
        self,
        params,
        *,
        mesh: Mesh | None = None,
        iters_per_pass: int = 4,
        local_compute: str = "kernel",
    ):
        super().__init__(params)
        if local_compute not in ("kernel", "plain"):
            raise ValueError(f"local_compute must be 'kernel' or 'plain' (got {local_compute!r})")
        if mesh is None:
            mesh = make_mesh(shape=(max(torch.cuda.device_count(), 1), 1))
        if len(mesh.shape) != 2:
            raise ValueError(f"the distributed backend takes a 2D ('y', 'x') mesh (got shape {mesh.shape})")
        self.mesh = mesh
        self.iters_per_pass = iters_per_pass
        self.local_compute = local_compute
        #: The configuration the last ``_update`` actually executed.
        self.resolved_config: dict | None = None

    def _devices(self, out: Grid) -> list:
        return [*self.mesh.device_set(), out.device]

    @torch.no_grad()
    def _update(self, grid: Grid) -> Grid:
        prm = self.params
        tf = prm.transition_function
        n, offset = int(prm.n_iterations), int(prm.iteration_offset)
        halo_cell = resolve_halo(prm.halo_value, grid)
        H, W = grid.shape
        ny, nx = self.mesh.shape
        r, k = tf.stencil_radius, tf.n_subiterations
        if n == 0:
            return Grid(grid.arrays)
        p = max(1, min(self.iters_per_pass, n))
        hp = halo_width(r, p, k)
        # Equal blocks, each at least one halo along a sharded axis.
        h = max(-(-H // ny), hp if ny > 1 else 1)
        w = max(-(-W // nx), hp if nx > 1 else 1)
        kernel = self.local_compute == "kernel"
        stored = (hp if ny > 1 else 0, hp if nx > 1 else 0) if kernel else (hp, hp)
        devices = self.mesh.devices
        padded = pad_grid(grid.arrays, halo_cell, ny * h, nx * w)
        blocks = [[cell_map(lambda a: a[iy * h : (iy + 1) * h, ix * w : (ix + 1) * w].to(devices[iy, ix])
                            .contiguous(), padded) for ix in range(nx)] for iy in range(ny)]
        del padded
        tdv = per_device(self._tdv_strategy().prepare(tf, offset, n, grid.device), self.mesh.device_set())
        self.resolved_config = dict(
            mesh=(ny, nx), local_compute=self.local_compute, iters_per_pass=p, shard=(h, w), stored_halo=stored,
        )
        if kernel:
            from .tiling import pick_config

            dev0 = devices[0, 0]
            th, tw, _ = pick_config(h, w, r, k, n, tile_cell_smem_bytes(grid.arrays, tf), device_limits(dev0), p,
                                    in_place=tile_writes(tf) is not None)
            self.resolved_config.update(tile_rows=th, tile_cols=tw)
        # The fields the functor only reads never change: their extended
        # blocks from the first exchange serve every pass.
        names, variant = cell_field_names(grid.arrays), getattr(tf, "cuda_variant", None)
        fixed = {j for j, name in enumerate(names) if variant is not None and name not in variant}
        kept = None
        for i_pass in range(-(-n // p)):
            i_start = offset + i_pass * p
            if not any(stored):
                ext = blocks
            elif kept is None:
                ext = exchange_halo(blocks, stored, self.mesh)
                kept = [[cell_leaves(e) for e in row] for row in ext]
            else:
                moved = {j: exchange_halo([[cell_leaves(b)[j] for b in row] for row in blocks], stored, self.mesh)
                         for j in range(len(kept[0][0])) if j not in fixed}
                ext = [[cell_unflatten(grid.arrays, [kept[iy][ix][j] if j in fixed else moved[j][iy][ix]
                                                     for j in range(len(kept[0][0]))])
                        for ix in range(nx)] for iy in range(ny)]
            for iy in range(ny):
                for ix in range(nx):
                    dev = devices[iy, ix]
                    origin = (iy * h - stored[0], ix * w - stored[1])
                    if kernel:
                        blocks[iy][ix] = tile_pass(
                            ext[iy][ix], tf, halo_cell, i_start=i_start, offset=offset, n_iterations=n,
                            iters_per_pass=p, tile=(th, tw), tdv=tdv[dev], origin=origin, grid_range=(H, W),
                            stored_halo=stored,
                        )
                    else:
                        stream = tdv[dev]
                        blocks[iy][ix] = fused_window_pass(
                            ext[iy][ix], tf, halo_cell, origin, (H, W), i_start, offset + n,
                            lambda step, i_abs, stream=stream: step_value(stream, i_abs - offset),
                            radius=r, n_subiterations=k, n_steps=p, row_mode="shrink", col_mode="shrink",
                        )
        return Grid(gather(blocks, grid.device, H, W))
