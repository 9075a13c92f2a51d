"""Ring backend: a temporal pipeline of row chunks over a ring of devices.

Counterpart of ``stencilstream_tpu/backends/ring.py`` (the reference's
multi-FPGA ring): N devices in a ring each apply their own ``p``
iterations to the grid as it streams through, so one lap advances ``N*p``
iterations. The grid streams as row chunks of ``chunk_rows``; the schedule
is the JAX package's, tick by tick:

* device 0 takes chunk ``j`` from the lap's grid at tick ``j``;
* device ``d`` computes chunk ``j`` at tick ``j + 1 + 2d``, from the window
  tail | cur | head(next): it keeps the last ``r*p*k`` rows of chunk
  ``j - 1`` and waits for chunk ``j + 1``, whose first rows are its
  lookahead halo; its iterations are ``offset + lap*N*p + d*p`` on;
* computed chunks move one device on per tick; the last device assembles
  the lap, and the root (device 0) takes it back for the next lap.

Partial laps (``n`` not a multiple of ``N*p``) pass cells through. Each
chunk update is the tile-pass kernel in extended mode over the chunk's
window (``local_compute="kernel"``, default; the plain version on CPU
devices) or the plain :func:`.fused.fused_window_pass`
(``local_compute="plain"``). What a position sends lands in the next
position's lap buffer, in which every window is a view (the kernel writes
there directly when both positions share a device), so nothing is
assembled per chunk. The JAX program computes every tick on every device;
here a chunk index outside ``[0, n_chunks)`` computes nothing, as its rows
never reach the grid. The JAX package's bool->int8 carries, sublane and
lane rounding and ``psum`` re-replication are TPU matters and have no
counterpart.
"""

from __future__ import annotations

import torch

from .. import tracing
from ..core.cell import cell_field_names, cell_leaves, cell_map
from ..core.grid import Grid
from ..parallel import Mesh, make_mesh
from ..tdv import step_value
from .base import StencilUpdateBase, resolve_halo
from .cuda_lib import device_limits, tile_cell_smem_bytes, tile_writes
from .distributed import per_device
from .fused import fused_window_pass, halo_width
from .tile_pass import tile_pass

__all__ = ["StencilUpdate"]


class StencilUpdate(StencilUpdateBase):
    """Ring (multi-device temporal pipeline) stencil updater.

    Extra keyword options:

    * ``mesh`` — a :class:`..parallel.Mesh` whose positions, in order, form
      the ring (default: every visible CUDA device, ``("ring",)``; raises
      when there is none). Several positions may name one device.
    * ``iters_per_pass`` — p iterations each device applies per lap.
    * ``chunk_rows`` — rows per streamed chunk, at least the halo
      ``r*p*n_subiterations`` (default: an eighth of the grid, at least
      the halo).
    * ``local_compute`` — ``"kernel"`` (default) or ``"plain"``.

    ``resolved_config`` holds the configuration the last call executed.
    """

    def __init__(
        self,
        params,
        *,
        mesh: Mesh | None = None,
        iters_per_pass: int = 2,
        chunk_rows: int | None = None,
        local_compute: str = "kernel",
    ):
        super().__init__(params)
        if local_compute not in ("kernel", "plain"):
            raise ValueError(f"local_compute must be 'kernel' or 'plain' (got {local_compute!r})")
        if mesh is None:
            mesh = make_mesh(shape=(max(torch.cuda.device_count(), 1),))
        self.mesh = mesh
        self.iters_per_pass = iters_per_pass
        self.chunk_rows = chunk_rows
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
        r, k = tf.stencil_radius, tf.n_subiterations
        if n == 0:
            return Grid(grid.arrays)
        devs = list(self.mesh.devices.flat)
        N = len(devs)
        kernel = self.local_compute == "kernel"
        with tracing.span("backends.plan") if tracing.on else tracing.OFF as span:
            p = max(1, min(self.iters_per_pass, n))
            look = halo_width(r, p, k)
            ch = self.chunk_rows or max(look, -(-H // 8))
            if ch < look:
                raise ValueError(
                    f"chunk_rows={ch} must be at least the halo r*p*k={look}; raise chunk_rows or lower "
                    f"iters_per_pass"
                )
            n_chunks = -(-H // ch)
            self.resolved_config = dict(
                ring=N, local_compute=self.local_compute, iters_per_pass=p, chunk_rows=ch, n_chunks=n_chunks,
            )
            if kernel:
                from .tiling import pick_config

                th, tw, _ = pick_config(ch, W, r, k, n, tile_cell_smem_bytes(grid.arrays, tf),
                                        device_limits(devs[0]), p, in_place=tile_writes(tf) is not None)
                self.resolved_config.update(tile_rows=th, tile_cols=tw)
            if span is not None:
                span.attrs["geometry"] = dict(self.resolved_config)
        n_ticks = (n_chunks + 1) + 2 * (N - 1) + 1
        lap_iters = N * p
        tdv = per_device(self._tdv_stream(grid), self.mesh.device_set())

        # A lap streams through one buffer per position: rows look.. hold
        # the lap's grid as that position receives it (position 0: the
        # lap's input; position d: what d-1 computed), with look rows on
        # either side (outside the grid, any bytes), so a chunk's window
        # tail | cur | head(next) is a view of rows [j*ch, j*ch + ch +
        # 2*look). The last position writes the next lap's input. The
        # fields the functor only reads are written once and never change.
        rows = n_chunks * ch + 2 * look

        def buffer(device):
            buf = cell_map(lambda a: torch.zeros((rows, W), dtype=a.dtype, device=device), grid.arrays)
            cell_map(lambda b, a: b[look : look + H].copy_(a), buf, grid.arrays)
            return buf

        lap_in, lap_out = buffer(devs[0]), buffer(devs[-1])
        stream = [lap_in] + [buffer(devs[d]) for d in range(1, N)]
        names, variant = cell_field_names(grid.arrays), getattr(tf, "cuda_variant", None)
        moving = [j for j, name in enumerate(names) if variant is None or name in variant] if names else [0]

        def chunk_pass(d, i_start, j):
            """Position d's pass over chunk j, into the next position's
            buffer (the lap's output for the last)."""
            window = cell_map(lambda a: a[j * ch : j * ch + ch + 2 * look], stream[d])
            target = stream[d + 1] if d + 1 < N else lap_out
            dest = cell_map(lambda a: a[look + j * ch : look + (j + 1) * ch], target)
            origin = (j * ch - look, 0)
            if kernel:
                same = devs[min(d + 1, N - 1)] == devs[d]
                out = tile_pass(
                    window, tf, halo_cell, i_start=i_start, offset=offset, n_iterations=n, iters_per_pass=p,
                    tile=(th, tw), tdv=tdv[devs[d]], origin=origin, grid_range=(H, W), stored_halo=(look, 0),
                    out=dest if same else None,
                )
            else:
                out = fused_window_pass(
                    window, tf, halo_cell, origin, (H, W), i_start, offset + n,
                    lambda step, i_abs: step_value(tdv[devs[d]], i_abs - offset),
                    radius=r, n_subiterations=k, n_steps=p, row_mode="shrink", col_mode="pad",
                )
            pairs = [(cell_leaves(out)[jf], cell_leaves(dest)[jf]) for jf in moving]
            copies = [(got, want) for got, want in pairs if got.data_ptr() != want.data_ptr()]
            if d + 1 < N and devs[d + 1] != devs[d]:
                exchange(copies, (i_start - offset) // p)
            else:
                for got, want in copies:
                    want.copy_(got)

        def exchange(copies, pass_index):
            """Copies between two devices, as one ``backends.exchange`` span."""
            with (tracing.span("backends.exchange", pass_index=pass_index, bytes=sum(
                    t.numel() * t.element_size() for t, _ in copies)) if tracing.on else tracing.OFF):
                for got, want in copies:
                    want.copy_(got)

        for lap in range(-(-n // lap_iters)):
            for tick in range(n_ticks):
                for d in range(N):
                    j = tick - 1 - 2 * d
                    if 0 <= j < n_chunks:
                        chunk_pass(d, offset + lap * lap_iters + d * p, j)
            # The root takes the lap back.
            if devs[-1] == devs[0]:
                stream[0], lap_out = lap_out, stream[0]
            else:
                exchange(list(zip(cell_leaves(lap_out), cell_leaves(stream[0]))), lap * N + N - 1)
        return Grid(cell_map(lambda a: a[look : look + H].to(grid.device).contiguous(), stream[0]))
