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
from stencilstream_tpu_torch.backends.tile_pass import IN_PLACE_RUN, RUN_ROWS, WARP, tile_pass, tile_smem_bytes
from stencilstream_tpu_torch.backends.tiling import IN_PLACE_LAW, REACH_LAW, TILE_LAW, pick_config
from stencilstream_tpu_torch.models import conway, jacobi
from stencilstream_tpu_torch.tdv import step_value, tdv_stream
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


#: A run loop of the vector map: 16-byte loads and a store, a 4-byte load,
#: shuffles, and an 8-byte load (each counted in 4-byte words).
VECTOR_SASS = """
        Function : _ZN2ss16tile_pass_kernelINS_16Jacobi5GeneralOpEEEvNS_12TilePassArgsIT_EES3_
        /*0000*/                   LDS.128 R4, [R3] ;                      /* 0x0000000003047984 */
        /*0010*/                   LDS R8, [R3+0x200] ;                    /* 0x0002000003087984 */
        /*0020*/                   SHFL.IDX PT, R9, R7, R2, 0x1f ;         /* 0x00001f0207097589 */
        /*0030*/                   SHFL.DOWN PT, R10, R4, 0x1, 0x1f ;      /* 0x08201f00040a7f89 */
        /*0040*/                   LDS.64 R12, [R3+0x10] ;                 /* 0x00001000030c7984 */
        /*0050*/                   FFMA R11, R4, R5, R6 ;                  /* 0x000000050404b223 */
        /*0060*/                   STS.128 [R5], R4 ;                      /* 0x0000000405007388 */
        /*0070*/              @P0 BRA 0x0 ;                                /* 0xfffffffc00000947 */
"""


def test_run_loops_counts_only_the_innermost_shared_memory_loop():
    from stencilstream_tpu_torch.tile_sweep import run_loops

    assert run_loops(SASS, "HotspotOp") == [{"instructions": 4, "LDS": 2, "STS": 1, "SHFL": 0}]
    assert run_loops(SASS, "ConwayOp") == [{"instructions": 3, "LDS": 1, "STS": 1, "SHFL": 0}]
    assert run_loops(SASS, "ProbeOp") == []
    assert run_loops(VECTOR_SASS, "Jacobi5GeneralOp") == [{"instructions": 8, "LDS": 7, "STS": 4, "SHFL": 2}]


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


#: (tile, halo, run, sh): the law's tiles at p=8 (HotSpot's 56x112 and
#: Jacobi5's 96x112), and the kernel tests' odd geometries: tiles narrower
#: than 128 columns (windows not a multiple of 4 or 16 wide), ragged runs,
#: p = 1 and 8.
VECTOR_GEOMETRY = [
    ((56, 112), 8, 8), ((96, 112), 8, 8), ((56, 112), 8, 4), ((64, 96), 8, 8), ((32, 64), 3, 8),
    ((20, 32), 8, 8), ((8, 32), 2, 8), ((16, 32), 1, 8), ((16, 32), 4, 8), ((32, 64), 1, 4),
]


@pytest.mark.parametrize("sh", [0, 1, 2, 3])
@pytest.mark.parametrize("tile, halo, run", VECTOR_GEOMETRY, ids=lambda v: str(v))
def test_vector_map_covers_every_narrowed_window_inside_the_planes(tile, halo, run, sh):
    """The vector map computes every cell of every narrowed window, reads
    and writes only inside the CTA's plane, and writes no cell that a later
    sub-step reads other than its own. With the planes unshifted it takes
    every sub-step; with sh = 2 it gives the first to the scalar map where
    the window fills the pitch."""
    from stencilstream_tpu_torch.tile_sweep import vector_map_work

    work = vector_map_work(tile, halo, 1, run, sh)
    assert work["uncovered"] == 0 and work["clobbered"] == 0
    assert 0 <= work["read"][0] and work["read"][1] < work["plane"]
    assert 0 <= work["written"][0] and work["written"][1] < work["plane"]
    window = tile[1] + 2 * halo
    assert work["scalar_steps"] == (1 if sh == 2 and window % 16 == 0 else 0)


def test_vector_map_at_the_laws_tile_computes_as_many_lanes_as_the_scalar_map():
    """At the law's tiles, halo 8, the window is exactly 128 columns: as
    many lane-cells a useful cell-step as the scalar map's 32-column chunks,
    1.35 at 56x112."""
    from stencilstream_tpu_torch.tile_sweep import thread_map_work, vector_map_work

    lanes = vector_map_work((56, 112), 8, 1, 8)["lane_cells_per_cell_step"]
    assert lanes == pytest.approx(67584 / 50176) == pytest.approx(thread_map_work((56, 112), 8, 1, 8)[0])
    assert round(lanes, 2) == 1.35
    assert vector_map_work((96, 112), 8, 1, 8)["lane_cells_per_cell_step"] == pytest.approx(
        thread_map_work((96, 112), 8, 1, 8)[0])
    with pytest.raises(ValueError, match="radius 1"):
        vector_map_work((56, 112), 8, 2)


#: (tile, halo) of the in-place map: FDTD's law tile at p=4 (halo 8) and
#: the ping-pong law's 16x128, and cores whose narrowed windows are not
#: whole warps (widths 100, 212, 2000) at p=4 and p=6 (k=2: halos 8, 12).
IN_PLACE_GEOMETRY = [((32, 128), 8), ((16, 128), 8),
                     *[((16, w), h) for w in (100, 212, 2000) for h in (8, 12)]]


@pytest.mark.parametrize("tile, halo", IN_PLACE_GEOMETRY, ids=lambda v: str(v))
def test_in_place_map_stores_every_narrowed_window_cell_once(tile, halo):
    """In place, every cell of each sub-step's narrowed window is stored by
    exactly one lane, and no lane stores outside it, whatever the windows'
    heights leave of the last run of 4 rows; the ping-pong map's
    shifted-back last chunk stores some cells twice wherever a narrowed
    window is not whole warps wide (harmless there, a race in place)."""
    from stencilstream_tpu_torch.tile_sweep import in_place_map_work, thread_map_work

    work = in_place_map_work(tile, halo, 1)
    assert (work["uncovered"], work["stored_twice"], work["outside"]) == (0, 0, 0)
    assert work["lane_cells_per_cell_step"] == pytest.approx(thread_map_work(tile, halo, 1, IN_PLACE_RUN)[0])
    ping_pong = in_place_map_work(tile, halo, 1, 1, in_place=False)
    assert (ping_pong["uncovered"], ping_pong["outside"]) == (0, 0)
    assert (ping_pong["stored_twice"] > 0) == any((tile[1] + 2 * (halo - s)) % 32 for s in range(1, halo + 1))


#: (tile, p) of the in-place map with FDTD's one-sided reach (halo p): the
#: reach law's tiles and the sweep's one- and two-CTA windows, and cores
#: whose narrowed windows are not whole warps (widths 100, 212, 2000), at p
#: from 4 to 8.
REACH_GEOMETRY = sorted({*[(entry[0], entry[1]) for entry in REACH_LAW.values()],
                         *[(t, p) for t in ((32, 128), (40, 112), (56, 80), (24, 88), (16, 120)) for p in (4, 7, 8)],
                         *[((16, w), p) for w in (100, 212, 2000) for p in (4, 5, 6, 7, 8)]})


@pytest.mark.parametrize("radius, k, reach, want", [
    (1, 1, None, [(1, 1), (2, 2), (3, 3)]),
    (2, 1, None, [(2, 2), (4, 4), (6, 6)]),
    (1, 2, None, [(1, 1), (2, 2), (3, 3), (4, 4), (5, 5), (6, 6)]),
    (1, 2, ((1, 0), (0, 1)), [(1, 0), (1, 1), (2, 1), (2, 2), (3, 2), (3, 3)]),
])
def test_pass_narrowing_sums_each_sub_steps_reach(radius, k, reach, want):
    """Sub-step s of a pass of p = 3 narrows the window by the low and the
    high reaches of sub-steps 0..s, r a side where the functor declares
    none; the pass's halo is the larger side at its end: r*p*k, or p for
    FDTD's one-sided reach."""
    from stencilstream_tpu_torch.backends import tile_pass as tp

    assert tp.pass_narrowing(radius, 3, k, reach) == want
    assert tp.pass_halo(radius, 3, k, reach) == max(want[-1]) == (3 if reach else radius * 3 * k)
    assert tp.pass_narrowing(radius, 0, k, reach) == [] and tp.pass_halo(radius, 0, k, reach) == 0


@pytest.mark.parametrize("tile, halo", REACH_GEOMETRY, ids=lambda v: str(v))
def test_in_place_map_narrows_by_the_reach_and_stores_every_cell_once(tile, halo):
    """With FDTD's reach, sub-step s narrows the window by the low reaches of
    sub-steps 0..s on the low side and their high reaches on the high side:
    every cell of each narrowed window is stored by exactly one lane and no
    lane stores outside it. Over the pass's 2p sub-steps the map computes
    fewer lane-cells a useful cell-step than the symmetric halo 2p does at
    the same tile."""
    from stencilstream_tpu_torch.tile_sweep import in_place_map_work

    reach = ((1, 0), (0, 1))
    work = in_place_map_work(tile, halo, 1, reach=reach)
    assert (work["uncovered"], work["stored_twice"], work["outside"]) == (0, 0, 0)
    assert work["lane_cells_per_cell_step"] < in_place_map_work(tile, 2 * halo, 1)["lane_cells_per_cell_step"]


def test_in_place_map_at_fdtds_law_tile():
    """FDTD's in-place law tile, 32x128 at p=4 in runs of 4 rows, computes
    1.53 lane-cells a useful cell-step (1.49 in one-cell runs), against
    1.77 at the ping-pong law's 16x128."""
    from stencilstream_tpu_torch.tile_sweep import in_place_map_work

    assert in_place_map_work((32, 128), 8, 1)["lane_cells_per_cell_step"] == pytest.approx(50176 / 32768)
    assert in_place_map_work((32, 128), 8, 1, 1)["lane_cells_per_cell_step"] == pytest.approx(48896 / 32768)
    assert in_place_map_work((16, 128), 8, 1, 1, in_place=False)["lane_cells_per_cell_step"] == pytest.approx(
        28928 / 16384)


@pytest.mark.parametrize("variant_bytes,rows", [(16, 4), (20, 3), (32, 2), (40, 1), (64, 1), (80, 1), (4, 4)])
def test_in_place_run_holds_at_most_64_bytes_of_outputs(variant_bytes, rows):
    """A lane's in-place run holds as many rows as keep its outputs within 64
    bytes, at most 4, at least one: FDTD's 16 B keep their 4 rows, the
    float64 convection cells (64, 80 B) take one, the float32 ones (32, 40
    B) two and one."""
    from stencilstream_tpu_torch.backends import tile_pass as tp

    assert tp.in_place_run_rows(variant_bytes) == rows


#: (tile, halo, run) of convection's in-place map: runs of 1 (its float64
#: cells, its float32 full cell) and 2 rows (its float32 lean cell); the
#: in-place law's tiles for its 88 B and 44 B cells and the sweep's, and
#: cores whose narrowed windows are not whole warps (width 100), at p = 1-3
#: (k = 3: halos 3, 6, 9).
CONVECTION_MAP_GEOMETRY = sorted({
    (tile, 3 * p, run)
    for tile in (IN_PLACE_LAW[88][0], IN_PLACE_LAW[44][0], (16, 46), (24, 52), (32, 32), (24, 48), (12, 58),
                 (16, 100))
    for p in (1, 2, 3) for run in (1, 2)
})


@pytest.mark.parametrize("tile, halo, run", CONVECTION_MAP_GEOMETRY, ids=lambda v: str(v))
def test_in_place_map_at_convections_runs_stores_every_cell_once(tile, halo, run):
    """At convection's run lengths every cell of each of a pass's 3p
    narrowed windows is stored by exactly one lane and no lane stores
    outside it, and the map computes what whole chunks and runs of that
    length cover."""
    from stencilstream_tpu_torch.tile_sweep import in_place_map_work, thread_map_work

    work = in_place_map_work(tile, halo, 1, run)
    assert (work["uncovered"], work["stored_twice"], work["outside"]) == (0, 0, 0)
    assert work["lane_cells_per_cell_step"] == pytest.approx(thread_map_work(tile, halo, 1, run)[0])


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


# -- extended mode: a block of a larger grid ----------------------------------


def _extended_case(app, block, seed):
    """(JAX tf, JAX halo, port tf, port halo, numpy block cell, TDV lookup
    for JAX's fused_window_pass) for a block of ``block`` cells."""
    import jax.numpy as jnp

    from stencilstream_tpu.models import jacobi as jj

    import probe as jprobe

    rng = np.random.default_rng(seed)
    if app == "hotspot":
        cell = _np_cell(block, seed)
        jk = jhs.HotspotKernel(**STRONG)
        return (jk, jhs.HotspotCell(temp=jnp.float32(5.0), power=jnp.float32(0.25)),
                interop.hotspot_kernel(dataclasses.asdict(jk)), hs.HotspotCell(temp=5.0, power=0.25), cell,
                lambda step, i_abs: None)
    if app == "jacobi5":
        jk = jj.make_kernel("jacobi5_general", [0.15, 0.2, 0.25, 0.1, 0.3])
        return (jk, jnp.float32(0.0), interop.jacobi_kernel("jacobi5_general", jk), 0.0,
                rng.random(block, np.float32), lambda step, i_abs: None)
    # The probe at radius 2 with its TDV (the iteration); cells at 7 whose
    # (r, c) are their global coordinates.
    cell = jprobe.make_probe_grid(*block, 7).to_numpy()
    return (jprobe.ProbeTransFunc(radius_=2), jprobe.probe_halo_cell(), probe.ProbeTransFunc(radius_=2),
            probe.probe_halo_cell(), cell, lambda step, i_abs: jnp.int32(i_abs))


def _torch_cell(np_cell):
    if dataclasses.is_dataclass(np_cell):
        return type(np_cell).__name__, {f.name: torch.tensor(np.asarray(getattr(np_cell, f.name)))
                                        for f in dataclasses.fields(np_cell)}
    return None, torch.tensor(np_cell)


def _port_cell(app, np_cell):
    name, fields = _torch_cell(np_cell)
    if app == "hotspot":
        return hs.HotspotCell(**fields)
    if app == "probe":
        return probe.ProbeCell(**fields)
    return fields


def _np_leaves(x):
    if dataclasses.is_dataclass(x):
        return [np.asarray(getattr(x, f.name)) for f in dataclasses.fields(x)]
    return [np.asarray(x)]


#: Block placements, by where the block's origin lies: inside the grid, to
#: the grid's top left (a negative origin, a corner shard), and past its
#: bottom right (a block that reaches beyond the grid, padding included).
PLACEMENTS = ["interior", "negative", "beyond"]


@pytest.mark.parametrize("app,placement", [(a, pl) for a in ("hotspot", "jacobi5") for pl in PLACEMENTS]
                         + [("probe", "negative")])
def test_extended_plain_pass_matches_jax_fused_window_pass(app, placement):
    """One pass of p=2 from iteration 7 (offset 6, n=4; then n=2, so 1 of
    2 steps is active) over a block with a stored halo of
    the pass's halo in rows and one more in columns, in a 40x50 grid: the
    port's tile pass (its plain version here) returns the core that JAX's
    ``fused_window_pass`` in pad mode computes over the same block at the
    same origin; its ``fused_window_pass`` in shrink mode equals JAX's
    under jit. Bit for bit, but for JAX's shrinking Jacobi5, which XLA
    contracts otherwise than its reference (within 1e-6, an ulp). The
    probe, radius 2 with its TDV, takes the corner shard only, at p=1: JAX
    compiles its windows slowly."""
    from stencilstream_tpu.backends import fused as jfused

    from stencilstream_tpu_torch.backends import fused as pfused

    r, k, p = (2, 2, 1) if app == "probe" else (1, 1, 2)
    (H, W), core = (40, 50), (10, 13)
    hp = r * p * k
    stored = (hp, hp + 1)
    block = (core[0] + 2 * stored[0], core[1] + 2 * stored[1])
    origin = {"interior": (5, 6), "negative": (-hp - 1, -hp),
              "beyond": (H - core[0] - stored[0] + 3, W - core[1] - stored[1] + 2)}[placement]
    jtf, jhalo, tf, halo, np_cell, lookup = _extended_case(app, block, 11)
    for i_start, offset, n in ((7, 6, 4), (7, 6, 2)):
        import jax

        jwin = jax.tree.map(jnp.asarray, np_cell)
        kw = dict(radius=r, n_subiterations=k, n_steps=p)
        jpad = jfused.fused_window_pass(jwin, jtf, jhalo, origin, (H, W), i_start, offset + n, lookup,
                                        row_mode="pad", col_mode="pad", **kw)
        got = tile_pass(_port_cell(app, np_cell), tf, halo, i_start=i_start, offset=offset, n_iterations=n,
                        iters_per_pass=p, tile=(8, 32), origin=origin, grid_range=(H, W), stored_halo=stored)
        # Cells of the core outside the grid: JAX's window pass masks every
        # field there; the port's pass, like JAX's extended strip pass,
        # returns the fields its functor only reads as they came in.
        rows = np.arange(core[0]) + origin[0] + stored[0]
        cols = np.arange(core[1]) + origin[1] + stored[1]
        inside = ((rows >= 0) & (rows < H))[:, None] & ((cols >= 0) & (cols < W))[None, :]
        for j, (g, w) in enumerate(zip(_np_leaves(jax.tree.map(np.asarray, jpad)), _np_leaves(got))):
            w = w.numpy() if isinstance(w, torch.Tensor) else w
            g = g[stored[0] : stored[0] + core[0], stored[1] : stored[1] + core[1]]
            if app == "hotspot" and j == 1:  # the power map, which HotSpot only reads
                g, w = g[inside], w[inside]
            np.testing.assert_array_equal(w, g)
        # Under jit, as JAX's backends run it (XLA fuses multiply-adds there).
        jshrink = jax.jit(lambda w: jfused.fused_window_pass(
            w, jtf, jhalo, origin, (H, W), i_start, offset + n, lookup, row_mode="shrink", col_mode="shrink",
            **kw))(jwin)
        pshrink = pfused.fused_window_pass(
            _port_cell(app, np_cell), tf, halo, origin, (H, W), i_start, offset + n,
            lambda step, i_abs: step_value(tdv_stream(tf, offset, n, "cpu"), i_abs - offset),
            row_mode="shrink", col_mode="shrink", **kw)
        for g, w in zip(_np_leaves(jax.tree.map(np.asarray, jshrink)), _np_leaves(pshrink)):
            w = w.numpy() if isinstance(w, torch.Tensor) else w
            if app == "jacobi5":  # XLA contracts JAX's shrinking Jacobi5 otherwise: an ulp apart
                np.testing.assert_allclose(w, g, rtol=0, atol=1e-6)
            else:
                np.testing.assert_array_equal(w, g)


def test_extended_pass_matches_jax_strip_pass_in_interpret_mode():
    """JAX's extended strip pass (``StripPass(mode="extended")``, Pallas in
    interpret mode) over a 32x32 HotSpot block, 8 stored halo rows and 4
    columns a side, at global (-4, 6) in a 30x40 grid, from iteration 7 of
    a call of n=5 from 3 at p=2 (1 of 2 steps active): the port's pass
    returns the same core bit for bit."""
    import jax

    from stencilstream_tpu.backends.strip_pass import StripPass
    from stencilstream_tpu.tdv import InlineTDV as JInline

    hpm, chm, core = 8, 4, (16, 24)
    block = (core[0] + 2 * hpm, core[1] + 2 * chm)
    np_cell = _np_cell(block, 12)
    jk = jhs.HotspotKernel(**STRONG)
    jcell = jax.tree.map(jnp.asarray, np_cell)
    jhalo = jhs.HotspotCell(temp=jnp.float32(5.0), power=jnp.float32(0.25))
    strategy = JInline()
    sp = StripPass(jcell, jk, jhalo, strategy, strategy.prepare(jk, 3, 5), radius=1, n_subiterations=1,
                   n_iterations=5, iters_per_pass=2, strip_rows=8, grid_range=(30, 40), mode="extended",
                   base_origin=jnp.int32(-4), col_halo=chm, base_col=jnp.int32(6), interpret=True)
    want = jax.tree.map(np.asarray, sp.run(jcell, 7, 3, -4, 6))
    got = tile_pass(interop.hotspot_grid(np_cell, device="cpu").arrays, interop.hotspot_kernel(
        dataclasses.asdict(jk)), hs.HotspotCell(temp=5.0, power=0.25), i_start=7, offset=3, n_iterations=5,
        iters_per_pass=2, tile=(8, 32), origin=(-4, 6), grid_range=(30, 40), stored_halo=(hpm, chm))
    np.testing.assert_array_equal(got.temp.numpy(), want.temp)
    np.testing.assert_array_equal(got.power.numpy(), want.power)


def test_extended_pass_refuses_a_stored_halo_short_of_the_pass():
    """A side may store less than the pass's halo only where the grid ends
    at or inside it."""
    from stencilstream_tpu_torch.backends.tile_pass import check_block

    check_block((20, 30), (0, 0), (20, 30), (0, 0), 8)  # clamped mode
    check_block((20, 30), (-2, 0), (40, 30), (2, 0), 2)
    with pytest.raises(ValueError, match="bottom"):
        check_block((20, 30), (-2, 0), (40, 30), (1, 0), 2)
    with pytest.raises(ValueError, match="left, right"):
        check_block((20, 30), (4, 3), (24, 40), (4, 1), 2)
    with pytest.raises(ValueError, match="no core"):
        check_block((8, 30), (0, 0), (8, 30), (4, 0), 2)
