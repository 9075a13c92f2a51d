"""The distributed backend with the grid resident in blocks (``BlockGrid``),
and the benchmark's four-card Jacobi5 cell, on a mesh of the CPU device
repeated four times.

A ``BlockGrid`` call takes the same pass loop as a whole ``Grid`` (shard,
run resident, gather), so it is held to the port's ``reference`` backend bit
for bit and to the JAX package's reference as ``test_torch_distributed.py``
holds a whole grid: on row slabs (4, 1) and on (2, 2) blocks, uneven ones
included, at n = 1, at a p that does not divide n, and over chained calls.
Then the grid type itself, the exchange's counters and spans, the cell's
plain reference in row bands, its app's inputs and grid conversions, and
the cell's check, which must fail with the exchange left out and with the
reference in bfloat16 in the program's place.
"""

from __future__ import annotations

import dataclasses
import json
import shutil

import numpy as np
import pytest
import torch

from test_torch_distributed import assert_matches, cpu_mesh, jax_run, make_case

from benchmark.check import compare, margin
from benchmark.layout import Layout
from benchmark.spec import Spec
from stencilstream_tpu_torch import BlockGrid, Grid, Params, create_update, tracing
from stencilstream_tpu_torch.backends import distributed

CELL = "jacobi5-81920-mesh4x1"
#: 26 x 30: blocks of 7 rows (the last 5) on (4, 1), 13 x 15 on (2, 2).
SHAPE = (26, 30)
APPS = ["hotspot", "jacobi5", "conway", "probe_radius2"]
MESHES = [(4, 1), (2, 2)]
#: (n a call, iterations a pass, calls): one iteration; a p that does not
#: divide n; the tile law's p (capped by the thinnest block) over chained calls.
RUNS = {"n1": (1, 2, 1), "p_not_dividing": (5, 2, 1), "chained": (4, 3, 3), "law_p_chained": (5, None, 2)}


def _params(case, n, offset):
    return Params(case.tf, halo_value=case.halo, iteration_offset=offset, n_iterations=n)


def _chained(case, mesh_shape, n, p, calls, **kw):
    """``calls`` calls of ``n`` iterations on the resident grid, each from
    the last one's output and iteration; the updater and the output."""
    mesh = cpu_mesh(mesh_shape)
    update = create_update(_params(case, n, case.offset), backend="distributed", mesh=mesh, iters_per_pass=p, **kw)
    grid = BlockGrid.shard(case.grid, mesh.devices)
    for i in range(calls):
        update.get_params().iteration_offset = case.offset + i * n
        grid = update(grid)
    return update, grid


_JAX = {}


@pytest.mark.parametrize("run", sorted(RUNS))
@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("app", APPS)
def test_resident_blocks_match_reference_and_jax(app, mesh_shape, run):
    n, p, calls = RUNS[run]
    if app.startswith("probe") and p is not None:
        p = 1  # radius 2, two sub-steps: a halo of 4 rows a pass, within the 5-row last slab
    case = make_case(app, shape=SHAPE, offset=2, n=n, seed=11)
    update, out = _chained(case, mesh_shape, n, p, calls)
    assert isinstance(out, BlockGrid) and out.mesh_shape == mesh_shape
    assert update.resolved_config["mesh"] == mesh_shape
    whole = dataclasses.replace(case, n=n * calls)
    want = create_update(_params(whole, whole.n, whole.offset), backend="reference")(case.grid)
    got = out.to_numpy()
    assert_matches(got, want.to_numpy(), "exact", whole.n, "port reference")
    key = (app, whole.n)
    if key not in _JAX:
        _JAX[key] = jax_run(whole, "reference")
    assert_matches(got, _JAX[key], whole.kind, whole.n, "JAX reference")
    if app.startswith("probe"):
        from stencilstream_tpu_torch import probe

        probe.check_probe_grid(out.gather(), whole.offset + whole.n)


@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_resident_blocks_on_the_plain_local_compute(mesh_shape):
    case = make_case("hotspot", shape=SHAPE, offset=2, n=5, seed=12)
    _, out = _chained(case, mesh_shape, 5, 2, 2, local_compute="plain")
    want = create_update(_params(case, 10, 2), backend="reference")(case.grid)
    assert_matches(out.to_numpy(), want.to_numpy(), "exact", 10, "port reference")


@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_a_call_leaves_its_input_and_returns_blocks_on_the_mesh(mesh_shape):
    """The input's cells are unchanged; the output is a BlockGrid on the
    mesh's devices whose variant field is new and whose field the functor
    only reads (HotSpot's power) is the input block's own tensor."""
    case = make_case("hotspot", shape=SHAPE, offset=0, n=6, seed=13)
    mesh = cpu_mesh(mesh_shape)
    grid = BlockGrid.shard(case.grid, mesh.devices)
    before = [[{f: t.clone() for f, t in dataclasses.asdict(b).items()} for b in row] for row in grid.blocks]
    out = create_update(_params(case, 6, 0), backend="distributed", mesh=mesh, iters_per_pass=4)(grid)
    for row, saved in zip(grid.blocks, before):
        for block, fields in zip(row, saved):
            assert all(torch.equal(getattr(block, f), t) for f, t in fields.items())
    assert out.mesh_shape == grid.mesh_shape and list(out.devices.flat) == list(mesh.devices.flat)
    for old, new in zip(grid.cells(), out.cells()):
        assert new.temp.data_ptr() != old.temp.data_ptr() and new.power is old.power
    assert not np.array_equal(out.to_numpy().temp, case.grid.to_numpy().temp)


def test_a_result_is_read_in_place_and_left_alone():
    """A result's blocks are the cores of framed buffers: the next call reads
    them in place, writing the neighbours' rows into their frames and none
    of their cells, and its results equal a call on copies of them."""
    case = make_case("jacobi5", shape=SHAPE, offset=0, n=5, seed=17)
    mesh = cpu_mesh((4, 1))
    update = create_update(_params(case, 5, 0), backend="distributed", mesh=mesh, iters_per_pass=2)
    first = update(BlockGrid.shard(case.grid, mesh.devices))
    bases = [b._base for b in first.cells()]
    cells = [b.clone() for b in first.cells()]
    frames = [torch.cat([base[:2], base[-2:]]).clone() for base in bases]
    second = update(first)
    assert all(torch.equal(b, c) for b, c in zip(first.cells(), cells))
    assert not all(torch.equal(torch.cat([base[:2], base[-2:]]), f) for base, f in zip(bases, frames))
    assert not any(new._base is base for new in second.cells() for base in bases)
    copied = update(BlockGrid([[c.clone()] for c in cells]))
    assert np.array_equal(second.to_numpy(), copied.to_numpy())


@pytest.mark.parametrize("frame", [1, 2, 6])
def test_framed_empty_blocks_are_read_in_place_where_their_frame_holds_the_halo(frame):
    """Blocks made by ``framed_empty`` with a frame of 2 or more rows (the
    halo at p = 2) are read in place; with 1 row they are copied; either way
    the cells are the reference's."""
    case = make_case("jacobi5", shape=(24, 30), offset=0, n=4, seed=18)
    mesh = cpu_mesh((4, 1))
    x = torch.from_numpy(case.grid.to_numpy())
    blocks = []
    for k in range(4):
        t = distributed.framed_empty((6, 30), dtype=x.dtype, device="cpu", frame=frame)
        t.copy_(x[6 * k:6 * k + 6])
        t._base[:frame].fill_(7.0)
        blocks.append([t])
    out = create_update(_params(case, 4, 0), backend="distributed", mesh=mesh, iters_per_pass=2)(BlockGrid(blocks))
    frame_rows = [b[0]._base[:frame] for b in blocks]
    written = [not torch.equal(f, torch.full_like(f, 7.0)) for f in frame_rows]
    assert written == [frame >= 2] * 4  # the neighbour's rows, or zeros at the mesh's edge
    want = create_update(_params(case, 4, 0), backend="reference")(case.grid)
    assert_matches(out.to_numpy(), want.to_numpy(), "exact", 4, "port reference")


def test_one_buffer_given_as_two_blocks_is_copied():
    """The same framed block at two mesh positions: its frame cannot take two
    neighbours' rows, so the call copies; the cells are a copy's."""
    case = make_case("jacobi5", shape=(12, 30), offset=0, n=3, seed=19)
    t = distributed.framed_empty((6, 30), dtype=torch.float32, device="cpu", frame=4)
    t.copy_(torch.from_numpy(case.grid.to_numpy())[:6])
    update = create_update(_params(case, 3, 0), backend="distributed", mesh=cpu_mesh((2, 1)), iters_per_pass=2)
    out = update(BlockGrid([[t], [t]]))
    want = update(BlockGrid([[t.clone()], [t.clone()]]))
    assert np.array_equal(out.to_numpy(), want.to_numpy())


def test_whole_grid_and_resident_blocks_take_the_same_loop():
    """A whole Grid on the mesh and its BlockGrid give the same cells, and
    only the whole grid's call is sharded and gathered."""
    case = make_case("jacobi5", shape=SHAPE, offset=0, n=9, seed=14)
    mesh = cpu_mesh((4, 1))
    update = create_update(_params(case, 9, 0), backend="distributed", mesh=mesh, iters_per_pass=None)
    tracing.enable()
    try:
        whole = update(case.grid)
        names_whole = [s.name for s in tracing.collect()]
        blocks = update(BlockGrid.shard(case.grid, mesh.devices))
        names_blocks = [s.name for s in tracing.collect()]
    finally:
        tracing.disable()
        tracing.collect()
    assert type(whole) is Grid and np.array_equal(whole.to_numpy(), blocks.to_numpy())
    assert names_whole.count("backends.shard") == names_whole.count("backends.gather") == 1
    assert "backends.shard" not in names_blocks and "backends.gather" not in names_blocks


def test_block_grid_type():
    x = torch.arange(7 * 5, dtype=torch.float32).reshape(7, 5)
    grid = BlockGrid.shard(Grid(x), [["cpu", "cpu"], ["cpu", "cpu"]])
    assert grid.shape == (7, 5) and grid.mesh_shape == (2, 2)
    assert [tuple(b.shape) for b in grid.cells()] == [(4, 3), (4, 2), (3, 3), (3, 2)]
    assert torch.equal(grid.gather().arrays, x)
    again = BlockGrid(grid.blocks)  # no copy
    assert all(a is b for a, b in zip(again.cells(), grid.cells()))
    assert np.array_equal(grid.to_numpy(), x.numpy())
    assert "2x2 blocks" in repr(grid) and grid.block_until_ready() is grid
    with pytest.raises(TypeError, match="distributed"):
        grid.arrays
    with pytest.raises(TypeError, match="gather"):
        grid.cell_at(5, 4)
    with pytest.raises(ValueError, match="share their height"):
        BlockGrid([[torch.zeros(4, 3), torch.zeros(3, 2)]])
    with pytest.raises(TypeError, match="dtype"):
        BlockGrid([[torch.zeros(4, 3)], [torch.zeros(4, 3, dtype=torch.float64)]])
    with pytest.raises(ValueError, match="empty"):
        BlockGrid.shard(Grid(torch.zeros(3, 5)), [["cpu"]] * 3 + [["cpu"]])


def test_backends_refuse_a_block_grid_that_does_not_fit():
    case = make_case("jacobi5", shape=SHAPE, offset=0, n=4, seed=15)
    grid = BlockGrid.shard(case.grid, cpu_mesh((4, 1)).devices)
    with pytest.raises(TypeError, match="distributed"):
        create_update(_params(case, 4, 0), backend="tiling")(grid)
    with pytest.raises(ValueError, match="mesh"):
        create_update(_params(case, 4, 0), backend="distributed", mesh=cpu_mesh((2, 2)))(grid)
    with pytest.raises(ValueError, match="thinner than the pass's halo"):
        create_update(_params(case, 8, 0), backend="distributed", mesh=cpu_mesh((4, 1)), iters_per_pass=8)(grid)
    # the tile law's p is lowered to the thinnest block (5 rows)
    update = create_update(_params(case, 8, 0), backend="distributed", mesh=cpu_mesh((4, 1)), iters_per_pass=None)
    update(grid)
    assert update.resolved_config["iters_per_pass"] == 5 and update.resolved_config["stored_halo"] == (5, 0)


@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_exchange_counters_and_spans(mesh_shape):
    """One exchange a pass; its strips and bytes from the rows and columns
    of the frames: every field's in a call's first pass, then HotSpot's
    temperature alone (its power never changes)."""
    n, p, H, W = 7, 3, 24, 20
    case = make_case("hotspot", shape=(H, W), offset=0, n=n, seed=16)
    mesh = cpu_mesh(mesh_shape)
    ny, nx = mesh_shape
    h, w = H // ny, W // nx
    grid = BlockGrid.shard(case.grid, mesh.devices)
    update = create_update(_params(case, n, 0), backend="distributed", mesh=mesh, iters_per_pass=p)
    passes, hr, hc = -(-n // p), (p if ny > 1 else 0), (p if nx > 1 else 0)
    row_strips, col_strips = 2 * (ny - 1) * nx, 2 * (nx - 1) * ny
    field_strips = row_strips + col_strips
    field_bytes = 4 * (row_strips * hr * w + col_strips * (h + 2 * hr) * hc)
    before = (distributed.exchanges, distributed.exchange_bytes)
    tracing.enable()
    try:
        update(grid)
        spans = [s for s in tracing.collect() if s.name == "backends.exchange"]
    finally:
        tracing.disable()
        tracing.collect()
    assert distributed.exchanges - before[0] == passes
    assert distributed.exchange_bytes - before[1] == (passes + 1) * field_bytes
    assert [s.attrs["pass_index"] for s in spans] == list(range(passes))
    assert [s.attrs["strips"] for s in spans] == [2 * field_strips] + [field_strips] * (passes - 1)
    assert [s.attrs["bytes"] for s in spans] == [2 * field_bytes] + [field_bytes] * (passes - 1)


# -- the benchmark's four-card cell ----------------------------------------------


@pytest.fixture(scope="module")
def spec():
    return Spec()


def _config(spec, **changes):
    return {**spec.config("jacobi5_mesh"), **changes}


@pytest.mark.parametrize("halo", [0.0, 0.5])
@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16], ids=str)
def test_banded_reference_is_the_whole_reference(spec, halo, dtype):
    """Row bands of 1, 3, 7 and the default rows agree with
    ``reference/jacobi5.py`` bit for bit on a whole grid."""
    cfg = _config(spec, halo_value={"value": halo})
    banded, whole = spec.reference("jacobi5_mesh"), spec.reference("jacobi5")
    x = torch.rand(33, 17, generator=torch.Generator().manual_seed(3))
    want = whole.run({"value": x}, 12, cfg, dtype)["value"]
    for rows in (1, 3, 7, banded.BAND_ROWS):
        assert torch.equal(banded.run({"value": x}, 12, cfg, dtype, band_rows=rows)["value"], want)


@pytest.mark.parametrize("halo", [0.0, 0.5])
def test_banded_reference_on_a_block(spec, halo):
    """A block with ``origin`` and ``extent`` gives the whole grid's cells
    at least n from each cut, and refuses a block outside the extent."""
    cfg, ref = _config(spec, halo_value={"value": halo}), spec.reference("jacobi5_mesh")
    x = torch.rand(40, 36, generator=torch.Generator().manual_seed(4))
    n = 5
    want = ref.run({"value": x}, n, cfg)["value"]
    for (r0, r1), (c0, c1) in [((0, 17), (0, 36)), ((9, 31), (4, 30)), ((20, 40), (11, 36))]:
        got = ref.run({"value": x[r0:r1, c0:c1]}, n, cfg, origin=(r0, c0), extent=(40, 36), band_rows=4)["value"]
        top = 0 if r0 == 0 else n
        bottom = 0 if r1 == 40 else n
        left = 0 if c0 == 0 else n
        right = 0 if c1 == 36 else n
        inner = (slice(top, r1 - r0 - bottom), slice(left, c1 - c0 - right))
        assert torch.equal(got[inner], want[r0:r1, c0:c1][inner])
    with pytest.raises(ValueError, match="does not lie"):
        ref.run({"value": x}, 1, cfg, origin=(1, 0), extent=(40, 36))


def test_app_block_inputs_follow_the_seed_and_the_block_start(spec):
    app = spec.app("jacobi5_mesh")
    seed = 2**33 + 5
    a = app.make_block_inputs(100, 60, seed, range(20, 30), range(0, 60), "cpu")["value"]
    # the same block start and size in another grid: the same values
    assert torch.equal(a, app.make_block_inputs(400, 60, seed, range(20, 30), range(0, 60), "cpu")["value"])
    assert not torch.equal(a, app.make_block_inputs(100, 60, seed + 1, range(20, 30), range(0, 60), "cpu")["value"])
    assert not torch.equal(a, app.make_block_inputs(100, 60, seed, range(30, 40), range(0, 60), "cpu")["value"])
    assert 0.5 <= a.min() and a.max() <= 1.5
    whole = app.make_inputs(10, 60, seed, "cpu")["value"]
    assert torch.equal(whole, app.make_block_inputs(10, 60, seed, range(10), range(60), "cpu")["value"])


def test_app_grid_round_trip_is_views(spec):
    app = spec.app("jacobi5_mesh")
    layout = Layout(26, 30, (2, 2), ["cpu"] * 4)
    blocks = {key: app.make_block_inputs(26, 30, 7, rows, cols, device)
              for key, (rows, cols, device) in layout.blocks.items()}
    grid = app.to_grid(blocks)
    assert isinstance(grid, BlockGrid) and grid.shape == (26, 30) and grid.mesh_shape == (2, 2)
    back = app.from_grid(grid, layout)
    assert set(back) == set(blocks) and all(back[k]["value"] is blocks[k]["value"] for k in blocks)
    with pytest.raises(ValueError, match="layout"):
        app.from_grid(grid, Layout(30, 30, (2, 2), ["cpu"] * 4))


def test_app_update_keeps_the_grid_in_blocks(spec):
    """The cell's updater, on a CPU mesh at a test size: ``distributed`` at
    the tile law's p, a BlockGrid in and out, the cells of
    ``reference/jacobi5_mesh.py`` within float32's rounding."""
    app, cfg, ref = spec.app("jacobi5_mesh"), spec.config("jacobi5_mesh"), spec.reference("jacobi5_mesh")
    traffic = {**spec.traffic("sq81920-n200-mesh4x1"), "height": 48, "width": 40, "n_iterations": 12}
    layout = Layout(48, 40, (4, 1), ["cpu"] * 4)
    blocks = {key: app.make_block_inputs(48, 40, 9, rows, cols, device)
              for key, (rows, cols, device) in layout.blocks.items()}
    update = app.make_update(cfg, traffic)
    out = update(app.to_grid(blocks))
    assert isinstance(out, BlockGrid) and update.resolved_config["iters_per_pass"] == 8  # the law's, as at the cell
    got = torch.cat([app.from_grid(out, layout)[k]["value"] for k in sorted(layout.blocks)])
    want = ref.run({"value": torch.cat([blocks[k]["value"] for k in sorted(blocks)])}, 12, cfg)["value"]
    assert (got.double() - want).abs().max() < 12 * 2 * 2.0**-23 * want.abs().max()


@pytest.fixture
def small_cell(tmp_path):
    """A copy of the benchmark whose four-card cell is cut to 96 x 80 cells,
    7 iterations a call; every block on the CPU."""
    shutil.copy(Spec().root / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(Spec().bench, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    path = tmp_path / "benchmark/traffic/sq81920-n200-mesh4x1.json"
    path.write_text(json.dumps({**json.loads(path.read_text()), "height": 96, "width": 80, "n_iterations": 7}))
    return tmp_path


def _cell_run(root, wrap=None):
    from benchmark.run import run_cell

    return run_cell(Spec(root), CELL, 2**31 + 977, 0.3, False, device="cpu", wrap=wrap)


def test_the_cell_is_correct_at_a_test_size(small_cell):
    result = _cell_run(small_cell)
    assert result["correct"] is True and result["device"]["count"] == 4 and result["attempted"] >= 2


def test_the_cell_fails_with_the_exchange_left_out(small_cell, monkeypatch):
    """Each block's frames left at zero, as if no neighbour sent its rows:
    both numbers compared exceed the cell's limits."""
    def frames_zeroed(framed, halo):
        for row in framed:
            for buf in row:
                buf[:halo[0]].zero_()
                buf[buf.shape[0] - halo[0]:].zero_()
        return 0, 0

    monkeypatch.setattr(distributed, "exchange_frames", frames_zeroed)
    result = _cell_run(small_cell)
    limits = Spec().limits(CELL)
    assert result["correct"] is False
    assert all(c["value"] > limits[k] for k, c in result["checks"].items())


def test_the_bfloat16_reference_fails_the_blocked_check(spec):
    """The control: the reference in bfloat16 in the program's place, its
    output cut into the cell's row slabs and compared block by block."""
    cfg, ref, app = spec.config("jacobi5_mesh"), spec.reference("jacobi5_mesh"), spec.app("jacobi5_mesh")
    H, W, n = 96, 80, 40
    layout = Layout(H, W, (4, 1), ["cpu"] * 4)

    def inputs(key):
        rows, cols, device = layout.blocks[key]
        return app.make_block_inputs(H, W, 77, rows, cols, device)

    whole = torch.cat([inputs(k)["value"] for k in sorted(layout.blocks)])
    control = ref.run({"value": whole}, n, cfg, torch.bfloat16)["value"].float()
    program = {key: {"value": control[rows.start:rows.stop, cols.start:cols.stop]}
               for key, (rows, cols, _) in layout.blocks.items()}
    err = compare(ref, cfg, n, layout, inputs, program, margin(cfg, n))
    assert err > max(spec.limits(CELL).values())

