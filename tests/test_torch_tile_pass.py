"""The tile-pass kernel's plain version and the tiling backend of the
PyTorch/CUDA port against the JAX package's tiling backend, run in Pallas
interpret mode on the CPU as tests/test_apps_on_backends.py runs it.

The kernels themselves are tested on the card by tests/test_torch_kernels.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencilstream_tpu.backends import create_update as j_create_update
from stencilstream_tpu.core import Grid as JGrid
from stencilstream_tpu.core import Params as JParams
from stencilstream_tpu.models import hotspot as jhs

from stencilstream_tpu_torch import Params, create_update, interop, probe
from stencilstream_tpu_torch.backends.cuda_lib import H100_SXM, DeviceLimits, cell_smem_bytes
from stencilstream_tpu_torch.backends.tile_pass import RUN_ROWS, WARP, tile_pass, tile_smem_bytes
from stencilstream_tpu_torch.backends.tiling import TILE_LAW, pick_config
from stencilstream_tpu_torch.models import conway, jacobi
from stencilstream_tpu_torch.models import hotspot as hs

#: Strong coefficients: each iteration moves temperatures by ~1e-1, so a
#: missing or extra step cannot hide under the tolerance.
STRONG = dict(Rx_1=np.float32(0.1), Ry_1=np.float32(0.1), Rz_1=np.float32(0.05), Cap_1=np.float32(0.5))


def _kernels(shape):
    return {
        "derived": jhs.derive_coefficients(*shape),
        "strong": jhs.HotspotKernel(**STRONG),
    }


def _np_cell(shape, seed=0):
    rng = np.random.default_rng(seed)
    return jhs.HotspotCell(
        temp=rng.uniform(70, 90, shape).astype(np.float32),
        power=rng.uniform(0, 1e-3, shape).astype(np.float32),
    )


@pytest.mark.parametrize("coeffs", ["derived", "strong"])
@pytest.mark.parametrize("shape", [(16, 24), (40, 72)], ids=["16x24", "40x72"])
def test_tiling_matches_jax_tiling(shape, coeffs):
    """n=5 from iteration_offset=3 at p=2 (the third pass is partial), halo
    value 0: the port's tiling on the CPU against JAX tiling (strip_rows=8,
    iters_per_pass=2, interpret mode), rtol 1e-6, atol 1e-5."""
    jkernel = _kernels(shape)[coeffs]
    np_cell = _np_cell(shape)
    j_params = JParams(
        transition_function=jkernel,
        halo_value=jhs.HotspotCell(temp=jnp.float32(0), power=jnp.float32(0)),
        iteration_offset=3,
        n_iterations=5,
    )
    j_out = j_create_update(j_params, backend="tiling", strip_rows=8, iters_per_pass=2)(
        JGrid.from_numpy(np_cell)
    ).to_numpy()
    update = create_update(
        Params(
            transition_function=interop.hotspot_kernel(dataclasses.asdict(jkernel)),
            halo_value=hs.HotspotCell(temp=0.0, power=0.0),
            iteration_offset=3,
            n_iterations=5,
        ),
        backend="tiling",
        iters_per_pass=2,
    )
    out = update(interop.hotspot_grid(np_cell, device="cpu")).to_numpy()
    assert update.resolved_config["iters_per_pass"] == 2
    np.testing.assert_allclose(out.temp, j_out.temp, rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(out.power, j_out.power)


@pytest.mark.parametrize("i_start,active", [(3, 2), (5, 1), (6, 0)])
def test_tile_pass_plain_is_a_partial_pass(i_start, active):
    """One pass of p=2 from ``i_start`` with offset 3 and n=3 runs exactly
    the steps before iteration 6 (exact in float32)."""
    kernel = hs.HotspotKernel(**STRONG)
    halo = hs.HotspotCell(temp=0.0, power=0.0)
    cell = interop.hotspot_grid(_np_cell((9, 11), 4), device="cpu").arrays
    out = tile_pass(cell, kernel, halo, i_start=i_start, offset=3, n_iterations=3, iters_per_pass=2,
                    tile=(8, 32))
    want = create_update(
        Params(kernel, halo_value=halo, iteration_offset=i_start, n_iterations=active),
        backend="reference",
    )(interop.hotspot_grid(_np_cell((9, 11), 4), device="cpu"))
    np.testing.assert_array_equal(out.temp.numpy(), want.arrays.temp.numpy())


def test_pick_config_reads_the_device():
    """The law's tile and halo per cell size (TILE_LAW) at 8192^2; the core
    shrinks (height first, never below twice the halo), then p, until the
    window fits the law's share of the shared memory."""
    assert pick_config(8192, 8192, 1, 1, 1000, 12, H100_SXM) == (56, 112, 8)
    assert pick_config(8192, 8192, 1, 1, 1000, 8, H100_SXM) == (96, 112, 8)
    assert pick_config(8192, 8192, 1, 1, 1000, 2, H100_SXM) == (64, 240, 8)
    assert pick_config(8192, 8192, 1, 2, 1000, 40, H100_SXM) == (32, 128, 2)
    assert pick_config(20, 24, 1, 1, 1000, 12, H100_SXM) == (24, 32, 8)
    assert pick_config(8192, 8192, 1, 1, 5, 12, H100_SXM)[2] == 5
    assert pick_config(8192, 8192, 1, 1, 1000, 16, H100_SXM) == (28, 112, 8)
    small = DeviceLimits(sm_count=4, smem_per_block=48 * 1024)
    th, tw, p = pick_config(8192, 8192, 1, 1, 1000, 12, small)
    assert tile_smem_bytes(th, tw, p, 12) <= small.smem_per_block // 2
    assert pick_config(8192, 8192, 1, 1, 1000, 12, small, iters_per_pass=8) == (14, 32, 8)
    tiny = DeviceLimits(sm_count=4, smem_per_block=4 * 1024)
    with pytest.raises(ValueError, match="shared memory"):
        pick_config(8192, 8192, 1, 1, 1000, 12, tiny, iters_per_pass=8)
    with pytest.raises(ValueError, match="halo"):
        pick_config(8, 8, 1, 1, 1000, 12, H100_SXM, iters_per_pass=9)


def _law_case(app):
    """(radius, sub-iterations, shared-memory bytes of one cell) of an app's
    transition function, the bytes counted from its real cell."""
    if app == "hotspot":
        cell, tf = interop.hotspot_grid(_np_cell((2, 2)), device="cpu").arrays, hs.HotspotKernel(**STRONG)
    elif app == "jacobi5":
        cell, tf = torch.zeros(2, 2), jacobi.make_kernel("jacobi5_general", [0.1] * 5)
    elif app == "conway":
        cell, tf = torch.zeros(2, 2, dtype=torch.bool), conway.ConwayKernel()
    else:
        cell, tf = probe.make_probe_grid(2, 2, 0, device="cpu").arrays, probe.ProbeKernel()
    return tf.stencil_radius, tf.n_subiterations, cell_smem_bytes(cell, tf)


@pytest.mark.parametrize("shape", [(8192, 8192), (1024, 1024), (37, 1003)], ids=["8192", "1024", "37x1003"])
@pytest.mark.parametrize("app", ["hotspot", "jacobi5", "conway", "probe"])
def test_pick_config_fits_thread_map_and_budget(app, shape):
    """At H100 SXM limits the law's tile takes the thread map (at least a
    warp wide, whole runs tall, its core or its window whole warps wide), is
    no larger than the grid needs, its window fits the share of shared
    memory the law sizes it for, and its halo is no larger than the core."""
    radius, k, cell_bytes = _law_case(app)
    assert cell_bytes == {"hotspot": 12, "jacobi5": 8, "conway": 2, "probe": 40}[app]
    th, tw, p = pick_config(*shape, radius, k, 200, cell_bytes, H100_SXM)
    _, _, ctas = TILE_LAW[cell_bytes]
    halo = radius * p * k
    assert tw >= WARP and th % RUN_ROWS == 0
    assert tw % WARP == 0 or (tw + 2 * halo) % WARP == 0
    assert th <= -(-shape[0] // RUN_ROWS) * RUN_ROWS and tw <= -(-shape[1] // WARP) * WARP
    assert tile_smem_bytes(th, tw, halo, cell_bytes) <= H100_SXM.smem_per_block // ctas
    assert 1 <= p and halo <= min(th, tw)


#: A cuobjdump -sass excerpt: a run loop (0x10-0x40) inside a sub-step loop
#: (0x10-0x60), a staging loop with a global-to-shared copy (0x70-0xa0),
#: and another functor's kernel that must not be counted.
SASS = """
        Function : _ZN2ss16tile_pass_kernelINS_9HotspotOpEEEvNS_12TilePassArgsIT_EES3_
        /*0000*/                   MOV R1, c[0x0][0x28] ;                  /* 0x00000a0000017a02 */
        /*0010*/                   LDS R2, [R3] ;                          /* 0x0000000003027984 */
        /*0020*/                   LDS R4, [R3+0x4] ;                      /* 0x0000040003047984 */
        /*0030*/                   STS [R5], R2 ;                          /* 0x0000000205007388 */
        /*0040*/              @P0 BRA 0x10 ;                               /* 0xfffffffc00000947 */
        /*0050*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;           /* 0x0000000000007b1d */
        /*0060*/              @P1 BRA 0x10 ;                               /* 0xfffffffc00000947 */
        /*0070*/                   LDGSTS.E.BYPASS.128 [R1], [R2.64] ;     /* 0x0000000002017fae */
        /*0080*/                   LDS R2, [R3] ;                          /* 0x0000000003027984 */
        /*0090*/                   STS [R5], R2 ;                          /* 0x0000000205007388 */
        /*00a0*/                   BRA 0x70 ;                              /* 0xfffffffc00000947 */
        Function : _ZN2ss16tile_pass_kernelINS_8ConwayOpEEEvNS_12TilePassArgsIT_EES3_
        /*0000*/                   LDS.U8 R2, [R3] ;                       /* 0x0000000003027984 */
        /*0010*/                   STS.U8 [R5], R2 ;                       /* 0x0000000205007388 */
        /*0020*/                   BRA 0x0 ;                               /* 0xfffffffc00000947 */
"""


def test_run_loops_counts_only_the_innermost_shared_memory_loop():
    from stencilstream_tpu_torch.tile_sweep import run_loops

    assert run_loops(SASS, "HotspotOp") == [{"instructions": 4, "LDS": 2, "STS": 1}]
    assert run_loops(SASS, "ConwayOp") == [{"instructions": 3, "LDS": 1, "STS": 1}]
    assert run_loops(SASS, "ProbeOp") == []


@pytest.mark.parametrize(
    "tile, halo, radius, run, want",
    [
        # 64x64, halo 8: windows 78..64 wide in 96- or 64-lane chunks.
        ((64, 64), 8, 1, 8, ((3 * 96 * 80 + 4 * 96 * 72 + 64 * 64) / (8 * 64 * 64),
                             sum((64 + 2 * (8 - s)) ** 2 for s in range(1, 9)) / (8 * 64 * 64))),
        # One sub-step on an aligned window: nothing wasted, nothing recomputed.
        ((32, 32), 1, 1, 1, (1.0, 1.0)),
    ],
)
def test_thread_map_work_counts_whole_chunks_and_runs(tile, halo, radius, run, want):
    from stencilstream_tpu_torch.tile_sweep import thread_map_work

    assert thread_map_work(tile, halo, radius, run) == pytest.approx(want)


@pytest.mark.parametrize("seen,want", [(5, 0.8), (4, 0.8), (10, 1.6), (9, 1.6)])
def test_device_ms_averages_the_launches_the_profiler_saw(monkeypatch, seen, want):
    """``tile_sweep.device_ms`` is the mean device time of the launches the
    profiler recorded (0.8 ms each here), times the launches a call makes
    (1 where it saw about 5 in 5 calls, 2 where about 10): a launch it
    missed (one of five in some windows) does not shorten the mean."""
    from stencilstream_tpu_torch import tile_sweep, trace_cells

    def fake_profiled(fn):
        fn()
        return None, {"void ss::tile_pass_kernel<ss::HotspotOp>(args)": {"ms": 0.8 * seen, "count": seen}}, {}

    monkeypatch.setattr(trace_cells, "profiled", fake_profiled)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    calls = []
    assert tile_sweep.device_ms(lambda: calls.append(1), 5) == pytest.approx(want)
    assert len(calls) == 6
