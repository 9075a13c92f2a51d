"""Distributed backend: the grid held in blocks over a 2D mesh of devices,
halos exchanged every pass.

Counterpart of ``stencilstream_tpu/backends/distributed.py``. The grid is
one block per position of a ``("y", "x")`` mesh (:mod:`..parallel`), each
on its position's device. A :class:`..core.grid.BlockGrid` stays there: a
call returns one on the same devices, and only halo strips move between
them. A whole :class:`..core.grid.Grid` takes the same pass loop: it is
padded (with the halo value; padded cells are out of the grid) to a
multiple of the mesh and cut into blocks, each copied to its device (span
``backends.shard``), and the result joined on its device (span
``backends.gather``).

A block lives in a framed buffer on its device: its core with the stored
halo (``r*p*k`` cells, :func:`.fused.halo_width`) on each side along a
sharded mesh axis. Where the mesh shards rows alone, a result's blocks are
the cores of such buffers (:func:`_framed_core`), as are blocks made by
:func:`framed_empty`, and the next call reads them in place, writing only
their frames; any other block is copied into a new framed buffer once a
call. A call writes into two new buffers shaped as the first. Each pass of
``p`` fused iterations fills the frames of the buffer it reads from the
neighbours' cores (:func:`..parallel.exchange_frames`: only the strips,
each a copy to the receiving device ordered by CUDA events on the cards'
current streams, no host synchronize; span ``backends.exchange``, counters
:data:`exchanges` and :data:`exchange_bytes`), then computes each block's
new core into the other buffer:

* ``local_compute="kernel"`` (default; JAX's ``"pallas"``): the tile-pass
  kernel in extended mode, the block's global origin and the grid's extent
  passed in, one binding a block a call (:class:`.cuda_lib.Binding`, on its
  device's current stream) launched through :func:`.tile_pass.bound_tile_pass`.
  Where the mesh does not split columns the new core is whole rows of the
  other buffer, and the kernel writes it there (``out=``); elsewhere it is
  copied in. On CPU devices the kernel's plain version. A mesh axis of one
  position stores no halo: its blocks span the grid along it.
* ``local_compute="plain"`` (JAX's ``"xla"``): the plain cross-check path,
  :func:`.fused.fused_window_pass` shrinking both axes by the halo. Only an
  explicit argument selects it.

Fields the device functor only reads (those ``cuda_variant`` does not name)
are framed and exchanged once a call: they never change, and a result's are
the input block's own tensors. A result's other fields are views of the
last buffer's core, whose frame the next call may write. Every block spans
at least the halo along a sharded axis, so the exchange is one hop: a whole
grid's blocks are padded to it, and a :class:`..core.grid.BlockGrid` with a
thinner block is refused (with ``iters_per_pass=None``, p is lowered to
fit). The JAX package's
lane-aligned column halo and sublane rounding are TPU layout rules, and its
fallback to the reference backend has no counterpart: a kernel that fails
raises.
"""

from __future__ import annotations

import itertools

import torch

from .. import tracing
from ..core.cell import cell_block_shape, cell_field_names, cell_leaves, cell_map, cell_unflatten
from ..core.grid import BlockGrid, Grid
from ..parallel import Mesh, exchange_frames, make_mesh
from ..tdv import step_value, stream_to
from .base import StencilUpdateBase, resolve_halo
from .cuda_lib import Binding, device_limits, tile_cell_smem_bytes, tile_writes
from .fused import fused_window_pass, halo_width
from .tile_pass import bound_tile_pass

__all__ = ["StencilUpdate", "framed_empty", "pad_grid", "per_device", "exchanges", "exchange_bytes"]

#: Halo exchanges made, one a pass of a mesh that stores a halo.
exchanges = 0
#: Bytes of the strips those exchanges copied from a neighbour's block
#: (every field's; the zeros written at the mesh's edges are not counted).
exchange_bytes = 0


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


def per_device(stream, devices) -> dict:
    """A call's TDV stream copied once to each device."""
    return {d: stream_to(stream, d) for d in devices}


def framed_empty(shape: tuple[int, int], *, dtype, device, frame: int) -> torch.Tensor:
    """An uninitialised ``shape`` tensor that is the core of a buffer with
    ``frame`` rows above and below it. A call given a :class:`BlockGrid`
    built from such blocks reads each in place, with no copy, where the mesh
    shards rows alone and ``frame`` holds the pass's stored halo: it writes
    the neighbours' rows into the frame, never into the block. A result's
    blocks are such cores too, so chained calls copy nothing."""
    buf = torch.empty((shape[0] + 2 * frame, shape[1]), dtype=dtype, device=device)
    return _framed_core(buf[frame:frame + shape[0]])


def _framed_core(core: torch.Tensor) -> torch.Tensor:
    """``core``, the rows of a buffer between equal frames, marked with its
    frame's rows so that a later call may read the buffer in place
    (:func:`_resident`); a core that is not whole rows stays unmarked."""
    root = core._base
    if root is not None and root.dim() == 2 and root.is_contiguous() and root.shape[1] == core.shape[1]:
        frame = (core.data_ptr() - root.data_ptr()) // (core.element_size() * core.shape[1])
        if root.shape[0] == core.shape[0] + 2 * frame:
            core._ss_frame = frame
    return core


def _resident(core: torch.Tensor, halo: int) -> torch.Tensor | None:
    """The rows of the buffer that ``core`` is marked as the core of
    (:func:`_framed_core`), with ``halo`` rows of its frame on either side,
    a view; ``None`` where it is unmarked or its frame is narrower."""
    frame = getattr(core, "_ss_frame", -1)
    if frame < halo:
        return None
    return core._base[frame - halo:frame + core.shape[0] + halo]


def _twin(rows: torch.Tensor) -> torch.Tensor:
    """The same rows of a new buffer shaped as the one ``rows`` lies in."""
    root = rows._base
    start = (rows.data_ptr() - root.data_ptr()) // (rows.element_size() * root.shape[1])
    return torch.empty_like(root)[start:start + rows.shape[0]]


def count_exchange(nbytes: int) -> None:
    """Count one halo exchange of ``nbytes`` bytes copied between blocks."""
    global exchanges, exchange_bytes
    exchanges += 1
    exchange_bytes += nbytes


class StencilUpdate(StencilUpdateBase):
    """Mesh-sharded stencil updater.

    Extra keyword options:

    * ``mesh`` — a :class:`..parallel.Mesh` with axes ``("y", "x")``
      (default: every visible CUDA device as a row mesh ``(n, 1)``; raises
      when there is none). Several positions may name one device. A
      :class:`..core.grid.BlockGrid` given to a call must have one block a
      position, on the position's device.
    * ``iters_per_pass`` — p, iterations fused between halo exchanges; the
      halo is ``r * p * n_subiterations`` per side. ``None``: the tile law's
      p at the block's shape, as ``tiling`` picks it
      (:func:`.tiling.pick_config`).
    * ``local_compute`` — ``"kernel"`` (default) or ``"plain"``.

    ``resolved_config`` holds the configuration the last call executed.
    """

    def __init__(
        self,
        params,
        *,
        mesh: Mesh | None = None,
        iters_per_pass: int | None = 4,
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
        return list(dict.fromkeys([*self.mesh.device_set(), out.device]))

    def _check_blocks(self, grid: BlockGrid) -> None:
        if grid.mesh_shape != self.mesh.shape or any(
                a != b for a, b in zip(grid.devices.flat, self.mesh.devices.flat)):
            raise ValueError(f"a BlockGrid of {grid.mesh_shape} blocks on {list(grid.devices.flat)} does not lie "
                             f"on the updater's {self.mesh.shape} mesh of {list(self.mesh.devices.flat)}")

    def _pick(self, proto, shape: tuple[int, int], n: int, p: int | None) -> tuple[int, int, int]:
        """:func:`.tiling.pick_config` for blocks of ``shape``: the tile and
        p (the law's where ``p`` is ``None``) as ``tiling`` picks them."""
        from .tiling import pick_config

        tf = self.params.transition_function
        return pick_config(*shape, tf.stencil_radius, tf.n_subiterations, n, tile_cell_smem_bytes(proto, tf),
                           device_limits(self.mesh.devices[0, 0]), p, in_place=tile_writes(tf) is not None)

    @torch.no_grad()
    def _update(self, grid: Grid) -> Grid:
        prm = self.params
        tf = prm.transition_function
        n = int(prm.n_iterations)
        blocked = isinstance(grid, BlockGrid)
        if blocked:
            self._check_blocks(grid)
        if n == 0:
            return BlockGrid(grid.blocks) if blocked else Grid(grid.arrays)
        proto = grid.blocks[0][0] if blocked else grid.arrays
        halo_cell = resolve_halo(prm.halo_value, Grid(proto))
        H, W = grid.shape
        ny, nx = self.mesh.shape
        rk = tf.stencil_radius * tf.n_subiterations
        kernel = self.local_compute == "kernel"
        if blocked:
            heights = [cell_block_shape(row[0])[0] for row in grid.blocks]
            widths = [cell_block_shape(cell)[1] for cell in grid.blocks[0]]
            shape = (max(heights), max(widths))
        else:
            shape = (-(-H // ny), -(-W // nx))
        p = self.iters_per_pass
        if p is None:
            p = self._pick(proto, shape, n, None)[2]
            if blocked:  # lowered until each block holds the halo along a sharded axis
                p = min(p, max(1, min([h for h in heights if ny > 1] + [w for w in widths if nx > 1] + [p * rk]) // rk))
        p = max(1, min(p, n))
        hp = halo_width(tf.stencil_radius, p, tf.n_subiterations)
        if not blocked:  # equal blocks, each at least one halo along a sharded axis
            shape = (max(shape[0], hp if ny > 1 else 1), max(shape[1], hp if nx > 1 else 1))
        tile = self._pick(proto, shape, n, p)[:2] if kernel else None
        shard = (heights[0], widths[0]) if blocked else shape
        stored = (hp if ny > 1 else 0, hp if nx > 1 else 0) if kernel else (hp, hp)
        if blocked and (ny > 1 and min(heights) < stored[0] or nx > 1 and min(widths) < stored[1]):
            raise ValueError(f"a BlockGrid's blocks of {heights} rows and {widths} columns are thinner than the "
                             f"pass's halo {hp} (iters_per_pass={p}) along a sharded axis")
        self.resolved_config = dict(mesh=(ny, nx), local_compute=self.local_compute, iters_per_pass=p, shard=shard,
                                    stored_halo=stored)
        if tile is not None:
            self.resolved_config.update(tile_rows=tile[0], tile_cols=tile[1])
        tdv = per_device(self._tdv_stream(grid), self.mesh.device_set())
        if blocked:
            return BlockGrid(self._run(grid.blocks, (H, W), halo_cell, p, stored, tile, tdv))
        h, w = shard
        devices = self.mesh.devices
        with tracing.span("backends.shard") if tracing.on else tracing.OFF:
            padded = pad_grid(grid.arrays, halo_cell, ny * h, nx * w)
            blocks = [[cell_map(lambda a: a[iy * h:(iy + 1) * h, ix * w:(ix + 1) * w].to(devices[iy, ix]), padded)
                       for ix in range(nx)] for iy in range(ny)]
            del padded
        out = self._run(blocks, (H, W), halo_cell, p, stored, tile, tdv)
        with tracing.span("backends.gather") if tracing.on else tracing.OFF:
            return Grid(cell_map(lambda a: a[:H, :W].contiguous(), BlockGrid(out).gather(grid.device).arrays))

    def _run(self, blocks, grid_range, halo_cell, p: int, stored: tuple[int, int], tile, tdv: dict) -> list:
        """The call's passes over ``blocks`` (a nested list of cells, one list
        a mesh row, each on any device), ``tdv`` the call's TDV stream on each
        device; returns the new blocks, each on its mesh position's device."""
        prm = self.params
        tf = prm.transition_function
        n, offset = int(prm.n_iterations), int(prm.iteration_offset)
        ny, nx = self.mesh.shape
        devices = self.mesh.devices
        hr, hc = stored
        proto = blocks[0][0]
        row0 = list(itertools.accumulate(cell_block_shape(row[0])[0] for row in blocks[:-1]))
        col0 = list(itertools.accumulate(cell_block_shape(cell)[1] for cell in blocks[0][:-1]))
        row0, col0 = [0, *row0], [0, *col0]
        names, variant = cell_field_names(proto), getattr(tf, "cuda_variant", None)
        n_fields = len(cell_leaves(proto))
        moving = [j for j in range(n_fields) if variant is None or not names or names[j] in variant]

        def core(buf):
            return buf[hr:buf.shape[0] - hr, hc:buf.shape[1] - hc]

        def framed(a, device):  # a new buffer, its core a copy of a's cells
            buf = torch.empty((a.shape[0] + 2 * hr, a.shape[1] + 2 * hc), dtype=a.dtype, device=device)
            core(buf).copy_(a)
            return buf[:]

        kernel = self.local_compute == "kernel"
        with tracing.span("backends.plan", geometry=self.resolved_config) if tracing.on else tracing.OFF:
            # src[iy][ix][j]: field j's framed rows a pass reads; dst: those it writes
            src, roots, borrowed = [], set(), []
            for iy in range(ny):
                for ix in range(nx):
                    leaves = cell_leaves(blocks[iy][ix])
                    # read in place where every field a pass writes is the core of its own framed buffer
                    own = [None if hc else _resident(leaves[j], hr) for j in moving]
                    ids = {id(b._base) for b in own if b is not None}
                    if None in own or len(ids) < len(own) or ids & roots:
                        own = [framed(leaves[j], devices[iy, ix]) for j in moving]
                    else:
                        borrowed.append((iy, ix))
                    roots |= {id(b._base) for b in own}
                    src.append([own[moving.index(j)] if j in moving else framed(t, devices[iy, ix])
                                for j, t in enumerate(leaves)])
            src = [src[iy * nx:(iy + 1) * nx] for iy in range(ny)]
            dst = [[[_twin(t) if j in moving else t for j, t in enumerate(b)] for b in row] for row in src]
            if kernel:  # one binding a block for every pass of the call
                bindings = [[Binding(cell_unflatten(proto, b), tf, halo_cell, offset, n) for b in row] for row in src]
                for iy in range(ny):
                    for ix in range(nx):
                        bindings[iy][ix].stream_tdv(tdv[devices[iy, ix]])
        for i_pass in range(-(-n // p)):
            i_start = offset + i_pass * p
            if any(stored):
                with (tracing.span("backends.exchange", pass_index=i_pass)
                      if tracing.on else tracing.OFF) as span:
                    moved = [exchange_frames([[b[j] for b in row] for row in src], stored)
                             for j in (range(n_fields) if i_pass == 0 else moving)]
                    strips, nbytes = sum(s for s, _ in moved), sum(b for _, b in moved)
                    if span is not None:
                        span.attrs.update(bytes=nbytes, strips=strips)
                count_exchange(nbytes)
            for iy in range(ny):
                for ix in range(nx):
                    cell = cell_unflatten(proto, src[iy][ix])
                    target = [core(t) for t in dst[iy][ix]]
                    origin = (row0[iy] - hr, col0[ix] - hc)
                    if kernel:
                        new = bound_tile_pass(
                            bindings[iy][ix], cell, i_start=i_start, iters_per_pass=p, tile=tile,
                            out=cell_unflatten(proto, target) if not hc else None, origin=origin,
                            grid_range=grid_range, stored_halo=stored,
                        )
                    else:
                        stream = tdv[devices[iy, ix]]
                        new = fused_window_pass(
                            cell, tf, halo_cell, origin, grid_range, i_start, offset + n,
                            lambda step, i_abs, stream=stream: step_value(stream, i_abs - offset),
                            radius=tf.stencil_radius, n_subiterations=tf.n_subiterations, n_steps=p,
                            row_mode="shrink", col_mode="shrink",
                        )
                    for j in moving:
                        t = cell_leaves(new)[j]
                        if t.data_ptr() != target[j].data_ptr():
                            target[j].copy_(t)
            src, dst = dst, src
            for iy, ix in borrowed if i_pass == 0 else ():  # the input's own buffers are never written
                dst[iy][ix] = [_twin(t) if j in moving else t for j, t in enumerate(dst[iy][ix])]
        return [[cell_unflatten(proto, [_framed_core(core(t)) if j in moving else cell_leaves(blocks[iy][ix])[j]
                                        for j, t in enumerate(src[iy][ix])]) for ix in range(nx)]
                for iy in range(ny)]
