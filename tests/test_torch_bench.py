"""The port's bench (``stencilstream_tpu_torch.bench``) against the JAX
package's (``stencilstream_tpu.bench``), on the CPU.

* The model: the same formulas as JAX's, so for equal rates (a ``TpuSpec``
  with the ``GpuSpec``'s bandwidth, derate and float32 peak) the roofline,
  the predicted runtime and the report agree to rel 1e-12; and at a derate
  of 1 the predicted runtime equals the bounds of PERF.md's kernel table
  (``experiments.common.bound_ms``), to rel 1e-12.
* The cases: each case's grid equals JAX's field by field, bit for bit,
  and three iterations of its updater on ``reference`` give JAX's result at
  the tolerance the app's own parity test states.
* The harness, the work counts (against ``tile_sweep``'s models of the same
  thread maps and ``parallel.exchange_halo``'s own writes), the curves and
  tables renderers, and the CLI on ``--device cpu``.
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from stencilstream_tpu.bench import __main__ as jmain
from stencilstream_tpu.bench import curves as jcurves
from stencilstream_tpu.bench import harness as jharness
from stencilstream_tpu.bench import model as jmodel
from stencilstream_tpu.bench import tables as jtables
from stencilstream_tpu.tdv import _batched_tdv

from stencilstream_tpu_torch import interop
from stencilstream_tpu_torch.bench import __main__ as pmain
from stencilstream_tpu_torch.bench import curves, harness, model, profile, tables
from stencilstream_tpu_torch.backends.cuda_lib import H100_SXM as H100_LIMITS
from stencilstream_tpu_torch.backends.line_cache import pick_linecache_config, warmup_rows
from stencilstream_tpu_torch.experiments import common
from stencilstream_tpu_torch.models.hotspot import HotspotCell
from stencilstream_tpu_torch.parallel import exchange_halo, make_mesh
from stencilstream_tpu_torch.tile_sweep import line_cache_work, thread_map_work

REPO = Path(__file__).resolve().parent.parent
SPEC = model.H100_SXM


def _tpu(spec=SPEC, **kw) -> jmodel.TpuSpec:
    """A JAX spec with the port spec's rates."""
    return jmodel.TpuSpec(hbm_bandwidth=spec.hbm_bandwidth, hbm_efficiency=spec.hbm_efficiency,
                          vpu_flops=spec.flops_f32, **kw)


# -- the model ------------------------------------------------------------------


@pytest.mark.parametrize("cell_bytes", [1, 4, 8, 44])
def test_roofline_matches_jax(cell_bytes):
    """rel 1e-12."""
    assert model.roofline_cells_per_s(SPEC, cell_bytes) == pytest.approx(
        jmodel.roofline_cells_per_s(_tpu(), cell_bytes), rel=1e-12)


RUNTIME_CASES = {
    "memory-bound, p=1": dict(grid_cells=8192 ** 2, n_iterations=64, cell_bytes=8),
    "temporal blocking, halo": dict(grid_cells=8192 ** 2, n_iterations=256, cell_bytes=8, iters_per_pass=8,
                                    halo_overhead=0.47, flops_per_cell=10),
    "compute overhead apart": dict(grid_cells=3072 * 1024, n_iterations=100, cell_bytes=44, iters_per_pass=2,
                                   halo_overhead=0.3, compute_overhead=0.8, flops_per_cell=50),
    "compute-bound, partial pass": dict(grid_cells=1024 ** 2, n_iterations=1001, cell_bytes=8,
                                        iters_per_pass=1000, flops_per_cell=10),
}


@pytest.mark.parametrize("case", RUNTIME_CASES)
def test_predicted_runtime_matches_jax(case):
    """The flops and the p/halo paths: rel 1e-12."""
    kw = RUNTIME_CASES[case]
    assert model.predicted_runtime(SPEC, **kw) == pytest.approx(jmodel.predicted_runtime(_tpu(), **kw), rel=1e-12)


@pytest.mark.parametrize("kw", [dict(), dict(iters_per_pass=8, halo_overhead=0.25, flops_per_cell=9)],
                         ids=["plain", "blocked"])
def test_model_report_matches_jax(kw):
    """Every JAX key, ``vpu_utilization`` as ``flop_utilization``: rel
    1e-12; ``hardware`` is the spec's name."""
    flops = kw.pop("flops_per_cell", 0.0)
    got = model.model_report(SPEC, 10 ** 6, 100, 8, 0.01, flops_per_cell=flops, **kw)
    want = jmodel.model_report(_tpu(), 10 ** 6, 100, 8, 0.01, flops_per_cell=flops, **kw)
    assert got["hardware"] == SPEC.name
    want["flop_utilization"] = want.pop("vpu_utilization")
    for key, value in want.items():
        if key != "hardware":
            assert got[key] == pytest.approx(value, rel=1e-12), key


def test_float64_cells_use_the_float64_peak():
    """The compute term of a float64 cell divides by 34 TFLOP/s."""
    t = model.predicted_runtime(SPEC, 10 ** 6, 1000, 88, iters_per_pass=1000, flops_per_cell=50, dtype="float64")
    assert t == pytest.approx(10 ** 6 * 1000 * 50 / 34e12, rel=1e-12)


@pytest.mark.parametrize("what", ["hotspot 1024^2 n=1000", "jacobi5 8192^2 one p=8 pass"])
def test_model_at_full_rate_equals_the_kernel_table_bound(what):
    """At ``hbm_efficiency=1`` the model of one resident-grid call of HotSpot
    1024^2, n=1000 (10 operations a cell) and of one Jacobi5 8192^2 pass of
    p=8 (4 B a cell read and written) equals PERF.md's bounds, 0.1565 ms
    (operations) and 0.1603 ms (bytes): rel 1e-12."""
    full = dataclasses.replace(SPEC, hbm_efficiency=1.0)
    if what.startswith("hotspot"):
        cells, n, flops = 1024 ** 2, 1000, 10
        t = model.predicted_runtime(full, cells, n, 8, iters_per_pass=n, flops_per_cell=flops)
        want = common.bound_ms(12 * cells, flops * n * cells)
        assert want[1] == "operations" and round(want[0], 4) == 0.1565
    else:
        cells, p, flops = 8192 ** 2, 8, 9
        t = model.predicted_runtime(full, cells, p, 4, iters_per_pass=p, flops_per_cell=flops)
        want = common.bound_ms(8 * cells, flops * p * cells)
        assert want[1] == "bytes" and round(want[0], 4) == 0.1603
    assert t * 1e3 == pytest.approx(want[0], rel=1e-12)


def test_one_table_of_peaks():
    """``experiments/common.py`` and ``chip_smoke.py`` read the card's
    peaks from ``bench/model.py``'s one table."""
    assert (common.HBM_BYTES_PER_S, common.FP32_FLOP_PER_S, common.FP64_FLOP_PER_S) == (
        SPEC.hbm_bandwidth, SPEC.flops_f32, SPEC.flops_f64) == (3.35e12, 67e12, 34e12)
    smoke = (REPO / "chip_smoke.py").read_text()
    experiments = (REPO / "stencilstream_tpu_torch/experiments/common.py").read_text()
    assert "from stencilstream_tpu_torch.bench.model import H100_SXM" in smoke
    assert "from ..bench.model import H100_SXM" in experiments
    for source in (smoke, experiments):
        assert "3.35e12" not in source and "67e12" not in source and "34e12" not in source


@pytest.mark.parametrize("device", [None, "cpu", "meta"])
def test_detect_never_raises(device):
    """Off an H100, the H100 SXM's rates, marked as not this device's."""
    spec = model.GpuSpec.detect(device)
    assert spec.hbm_bandwidth == SPEC.hbm_bandwidth and spec.flops_f32 == SPEC.flops_f32
    if not torch.cuda.is_available():
        assert not spec.peaks_of_this_device and "not this device's" in spec.name


# -- the cases --------------------------------------------------------------------

#: Each app's grid size (convection: ``--size``, a resolution of size // 3).
SIZES = {"hotspot": 64, "jacobi": 64, "fdtd": 34, "convection": 48}
#: JAX's cell bytes (``stencilstream_tpu/bench/__main__.py:58,77,113,150``).
CELL_BYTES = {"hotspot": 8, "jacobi": 4, "fdtd": 32, "convection": 44}


def _leaves(arrays) -> list:
    if dataclasses.is_dataclass(arrays):
        return [np.asarray(getattr(arrays, f.name)) for f in dataclasses.fields(arrays)]
    return [np.asarray(arrays)]


def _cases(app, backend="reference"):
    size = SIZES[app]
    jgrid, jmake, jbytes, jflops = jmain.CASES[app](size, backend, {})
    grid, make, cell_bytes, flops = pmain.CASES[app](size, backend, {}, torch.device("cpu"))
    return (jgrid, jmake, jbytes, jflops), (grid, make, cell_bytes, flops)


@pytest.mark.parametrize("app", SIZES)
def test_case_grid_equals_jax_bit_for_bit(app):
    (jgrid, *_), (grid, *_) = _cases(app)
    want, got = jgrid.to_numpy(), grid.to_numpy()
    if dataclasses.is_dataclass(want):
        assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    for g, w in zip(_leaves(got), _leaves(want), strict=True):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("app", SIZES)
def test_case_cell_bytes_and_operations(app):
    """Cell bytes from the grid equal JAX's hard-coded 8, 4, 32 and 44; the
    operations are the transition function's ``n_operations`` (JAX's
    HotSpot case counts Rodinia's 15, the port the functor's 10)."""
    (_, _, jbytes, jflops), (grid, make, cell_bytes, flops) = _cases(app)
    assert cell_bytes == jbytes == CELL_BYTES[app]
    assert flops == make(1).get_params().transition_function.n_operations
    assert flops == (10 if app == "hotspot" else jflops)


def test_case_reference_hotspot_matches_jax():
    """Three iterations on ``reference``: rtol 1e-6, atol 1e-5
    (``test_torch_hotspot.py``)."""
    (jgrid, jmake, *_), (grid, make, *_) = _cases("hotspot")
    want, got = jmake(3)(jgrid).to_numpy(), make(3)(grid).to_numpy()
    np.testing.assert_allclose(got.temp, want.temp, rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(got.power, want.power)


def test_case_reference_jacobi_matches_jax():
    """Three iterations of Jacobi5 at halo 0: bit for bit
    (``test_torch_jacobi.py``)."""
    (jgrid, jmake, *_), (grid, make, *_) = _cases("jacobi")
    np.testing.assert_array_equal(make(3)(grid).to_numpy(), jmake(3)(jgrid).to_numpy())


def test_case_reference_fdtd_matches_jax():
    """Three iterations fed JAX's source amplitudes: bit for bit
    (``test_torch_fdtd.py``)."""
    (jgrid, jmake, *_), (grid, make, *_) = _cases("fdtd")
    jupdate, update = jmake(3), make(3)
    import jax.numpy as jnp

    update.get_params().tdv_strategy = interop.StreamTDV(
        np.asarray(_batched_tdv(jupdate.get_params().transition_function, jnp.arange(3))), 0)
    for g, w in zip(_leaves(update(grid).to_numpy()), _leaves(jupdate(jgrid).to_numpy()), strict=True):
        np.testing.assert_array_equal(g, w)


def test_case_reference_convection_matches_jax():
    """Three iterations of the full pseudo-transient kernel equal three
    one-iteration JAX calls (``test_torch_convection.py``: one JAX call of
    several iterations fuses across them) bit for bit, but where XLA's CPU
    code flushed a subnormal result to zero: the blob's tail gives a few
    near 1e-41 in the first iteration, which the port keeps and the next
    two carry into at most 12 cells a field, each still below 1e-36 where
    JAX holds 0."""
    (jgrid, jmake, *_), (grid, make, *_) = _cases("convection")
    want = jgrid
    for _ in range(3):
        want = jmake(1)(want)
    for g, w in zip(_leaves(make(3)(grid).to_numpy()), _leaves(want.to_numpy()), strict=True):
        apart = g != w
        assert apart.sum() <= 12 and (w[apart] == 0).all() and (np.abs(g[apart]) < 1e-36).all()


# -- the harness ------------------------------------------------------------------


def _result():
    return harness.run_benchmark(lambda: None, variant="unit.test", grid_shape=(4, 4), n_iterations=2,
                                 cell_bytes=4, flops_per_cell=3, n_samples=2, spec=SPEC)


def test_to_json_keys_match_jax():
    """The same keys as JAX's record, ``strip_kernel`` renamed ``kernel``."""
    want = jharness.run_benchmark(lambda: None, variant="unit.test", grid_shape=(4, 4), n_iterations=2,
                                  cell_bytes=4, flops_per_cell=3, n_samples=2, spec=_tpu())
    want.strip_kernel, got = {"n_passes": 1}, _result()
    got.kernel = {"n_passes": 1}
    assert set(got.to_json()) == set(want.to_json()) - {"strip_kernel"} | {"kernel"}
    assert "kernel" not in _result().to_json()


def test_run_protocol_warmup_and_samples():
    calls = []
    result = harness.run_benchmark(lambda: calls.append(1), variant="u", grid_shape=(4, 4), n_iterations=2,
                                   cell_bytes=4, n_samples=3, spec=SPEC)
    assert len(calls) == 4 and len(result.samples_s) == 3 and result.walltime_s == min(result.samples_s)
    cold = harness.run_benchmark(lambda: calls.append(1), variant="u", grid_shape=(4, 4), n_iterations=2,
                                 cell_bytes=4, n_samples=1, warmup=False, spec=SPEC)
    assert len(calls) == 5 and "set-up" in cold.to_json()["first_sample"]


def test_write_metrics_writes_card_and_stamp(tmp_path):
    path = harness.write_metrics(_result(), str(tmp_path), card="NVIDIA H100 80GB HBM3, 700.00 W")
    data = json.loads(Path(path).read_text())
    assert Path(path).name == "metrics.unit.test.json"
    assert data["card"] == "NVIDIA H100 80GB HBM3, 700.00 W" and data["recorded_utc"].endswith("Z")
    data = json.loads(Path(harness.write_metrics(_result(), str(tmp_path))).read_text())
    if not torch.cuda.is_available():
        assert data["card"] == "cpu: plain versions, host clock"


# -- work counts --------------------------------------------------------------------


def test_kernel_stats_tile_pass_matches_thread_map_work():
    """HotSpot 8192^2 at 56x112, p=8: 147 x 74 tiles; the window cells and
    lanes a useful cell-step are ``tile_sweep.thread_map_work``'s; the
    windows read 8 B a cell where they lie in the grid (the kernel stages
    the rest as the halo value) and the core's 4 B of temp are written."""
    config = dict(window_mode="clamped", tile_rows=56, tile_cols=112, iters_per_pass=8)
    s = profile.kernel_stats((8192, 8192), 4, 4, radius=1, n_subiterations=1, n_iterations=200, config=config)
    lanes, window = thread_map_work((56, 112), 8, 1, run=8)
    useful = 147 * 74 * 56 * 112 * 8
    assert s["per_pass"]["computed_cell_substeps"] == pytest.approx(window * useful, rel=1e-12)
    assert s["per_pass"]["lane_cell_substeps"] == pytest.approx(lanes * useful, rel=1e-12)
    # Rows: 147 windows of 72 rows, less 8 above the grid and 48 below it;
    # columns: 74 of 128, less 8 left and 104 right.
    assert s["per_pass"]["hbm_read_bytes"] == (147 * 72 - 8 - 48) * (74 * 128 - 8 - 104) * 8
    assert s["per_pass"]["hbm_write_bytes"] == 8192 * 8192 * 4
    assert (s["kernel"], s["n_passes"], s["launches"]) == ("tile_pass", 25, 25)


def test_kernel_stats_tile_pass_follows_a_declared_reach():
    """FDTD coef 2048^2 at 32x128, p=4, whose functor declares its one-sided
    reach: each window is the tile and a halo of 4 a side (not 8), staged
    at 32 B a cell where it lies in the grid, and the 8 sub-steps narrow it
    by 1, 2, ..., 8 cells, both sides together (``tile_sweep.in_place_map_work``'s
    windows), where the symmetric law narrows by 2, 4, ..., 16."""
    config = dict(window_mode="clamped", tile_rows=32, tile_cols=128, iters_per_pass=4)
    kw = dict(radius=1, n_subiterations=2, n_iterations=2736, config=config)
    s = profile.kernel_stats((2048, 2048), 16, 16, reach=((1, 0), (0, 1)), **kw)
    # Rows: 64 windows of 40, less 4 above the grid and 4 below it;
    # columns: 16 of 136, less 4 left and 4 right.
    assert s["per_pass"]["hbm_read_bytes"] == (64 * 40 - 8) * (16 * 136 - 8) * 32
    assert s["per_pass"]["computed_cell_substeps"] == 64 * 16 * sum((40 - m) * (136 - m) for m in range(1, 9))
    symmetric = profile.kernel_stats((2048, 2048), 16, 16, **kw)
    assert symmetric["per_pass"]["hbm_read_bytes"] == (64 * 48 - 16) * (16 * 144 - 16) * 32
    assert (s["launches"], s["per_pass"]["hbm_write_bytes"]) == (symmetric["launches"], 2048 * 2048 * 16) == (
        684, 2048 * 2048 * 16)


def test_kernel_stats_line_cache_matches_line_cache_work():
    """Jacobi5 8192^2 at the law's geometry: the lanes are
    ``tile_sweep.line_cache_work``'s for each segment (warm-up ``hp`` rows
    for the first one), and each cell is written once."""
    cfg = pick_linecache_config(8192, 8192, 1, 1, 200, 4, 0, H100_LIMITS)
    config = dict(window_mode="linecache", **cfg._asdict())
    s = profile.kernel_stats((8192, 8192), 4, 0, radius=1, n_subiterations=1, n_iterations=200, config=config)
    p, T, panel, seg = cfg.iters_per_pass, cfg.strip_rows, cfg.panel_cols, cfg.segment_rows
    n_panels = -(-8192 // panel)
    want = 0.0
    for y0 in range(0, 8192, seg):
        rows = min(seg, 8192 - y0)
        warm = p if y0 == 0 else warmup_rows(1, p, T)
        want += line_cache_work(panel, p, 1, T, rows, warm) * panel * p * rows * n_panels
    assert s["per_pass"]["lane_cell_substeps"] == pytest.approx(want, rel=1e-12)
    assert s["per_pass"]["hbm_write_bytes"] == 8192 * 8192 * 4
    # The law gives strips of 32, panels of 144 (windows of 160) and
    # segments of 320 rows. Rows a strip stages: 34 (2 above it), 32 for the
    # first strip (clipped at the top) and 26 for the last (at the bottom);
    # strips: 11 for the first segment (8 warm-up rows) and for each of the
    # 24 full ones (32), 7 for the last of 192. Columns: 57 windows of 160,
    # less 8 left and 24 right.
    assert (cfg.strip_rows, cfg.panel_cols, cfg.segment_rows) == (32, 144, 320)
    rows = (32 + 10 * 34) + 24 * 11 * 34 + (6 * 34 + 26)
    assert s["per_pass"]["hbm_read_bytes"] == rows * (57 * 160 - 8 - 24) * 4
    assert (s["kernel"], s["launches"]) == ("line_cache", 25)


@pytest.mark.parametrize("n", [1000, 1002])
def test_kernel_stats_resident_grid(n):
    """HotSpot 1024^2 on 8-row bands, q=4: each band computes the band and
    (g-1-j) rows a side at sub-step j of a group of g (4, and 2 for the last
    group when n=1002), less what lies outside the grid above the first
    band and below the last; one read of each band and its q rows a side,
    one write."""
    s = profile.kernel_stats((1024, 1024), 4, 4, radius=1, n_subiterations=1, n_iterations=n,
                             config=dict(band=8, q=4, n_ctas=128))
    groups = [4] * 250 + [2] * (n == 1002)
    interior = 128 * sum(sum(8 + 2 * m for m in range(g)) for g in groups) * 1024
    outside = 2 * sum(sum(range(g)) for g in groups) * 1024
    assert s["per_pass"]["computed_cell_substeps"] == interior - outside
    assert s["per_pass"]["hbm_read_bytes"] == (128 * 16 - 8) * 1024 * 8
    assert s["per_pass"]["hbm_write_bytes"] == 1024 * 1024 * 4
    assert (s["kernel"], s["n_passes"], s["launches"]) == ("monotile", 1, 1)


def test_kernel_stats_distributed_one_shard_is_the_tile_pass():
    """A (1, 1) mesh stores no halo: its one extended-mode launch a pass
    counts as the clamped tile pass over the grid."""
    tile = dict(tile_rows=56, tile_cols=112, iters_per_pass=4)
    kw = dict(radius=1, n_subiterations=1, n_iterations=256)
    one = profile.kernel_stats((2048, 2048), 4, 4, config=dict(mesh=(1, 1), shard=(2048, 2048),
                                                               stored_halo=(0, 0), **tile), **kw)
    clamped = profile.kernel_stats((2048, 2048), 4, 4, config=dict(window_mode="clamped", **tile), **kw)
    assert one["per_pass"] == clamped["per_pass"] and one["launches"] == clamped["launches"] == 64


@pytest.mark.parametrize("mesh_shape", [(2, 2), (4, 1)])
def test_exchange_report_counts_what_exchange_halo_writes(mesh_shape, monkeypatch):
    """On a mesh of repeated CPU devices, the bytes
    ``parallel.exchange_halo`` writes into each block's frame (copies from
    a neighbour and the zero-filled strips at the mesh's edges) are
    ``row_bytes + col_bytes`` a block, and the copies alone
    ``moved_bytes``."""
    H = W = 40
    hp, cell_bytes = 3, 8  # radius 1, p=3; two float32 fields
    ny, nx = mesh_shape
    h, w = H // ny, W // nx
    mesh = make_mesh(shape=mesh_shape, devices=["cpu"] * (ny * nx))
    blocks = [[HotspotCell(temp=torch.zeros(h, w), power=torch.zeros(h, w)) for _ in range(nx)] for _ in range(ny)]
    written = {"copy_": 0, "zero_": 0}
    for name in written:
        real = getattr(torch.Tensor, name)

        def counting(self, *args, _real=real, _name=name):
            written[_name] += self.numel() * self.element_size()
            return _real(self, *args)

        monkeypatch.setattr(torch.Tensor, name, counting)
    exchange_halo(blocks, (hp if ny > 1 else 0, hp if nx > 1 else 0), mesh)
    monkeypatch.undo()
    r = model.exchange_report(SPEC, mesh_shape, (H, W), cell_bytes, radius=1, iters_per_pass=hp)
    assert written["copy_"] + written["zero_"] == ny * nx * (r["row_bytes"] + r["col_bytes"])
    assert written["copy_"] == r["moved_bytes"] > 0
    assert 0 < r["exchange_fraction"]


def test_model_inputs_take_the_configuration_that_ran():
    """Through ``tiling``: the pass's p and bytes; ``monotile``: one pass of
    n; ``reference``: no kernel. The model then reads below the bound's
    share limit (here on the host, far below)."""
    for backend, kernel, p in [("tiling", "tile_pass", 8), ("monotile", "monotile", 16), ("reference", None, None)]:
        grid, make, cell_bytes, flops = pmain.CASES["hotspot"](64, backend, {}, torch.device("cpu"))
        update = make(16)
        update(grid)
        mk, stats = harness.model_inputs(update.get_params().transition_function, grid, backend, 16, 0.01, flops,
                                         update, spec=SPEC)
        if kernel is None:
            assert stats is None and mk == {"dtype": "float32"}
            continue
        assert stats["kernel"] == kernel and mk["iters_per_pass"] == p
        per_pass = stats["per_pass"]
        assert 64 * 64 * cell_bytes * (2 + mk["halo_overhead"]) == pytest.approx(
            per_pass["hbm_read_bytes"] + per_pass["hbm_write_bytes"], rel=1e-12)
        assert model.model_report(SPEC, 64 * 64, 16, cell_bytes, 0.01, flops_per_cell=flops,
                                  **mk)["model_accuracy"] < model.SHARE_LIMIT


# -- curves and tables --------------------------------------------------------------


def _metrics_dir(tmp_path):
    rows = [("hotspot.tiling", 512, 1.2e11, 0.9), ("hotspot.tiling", 1024, 2.5e11, 1.2),
            ("jacobi.jacobi5_general.tiling", 512, 3.0e11, 0.3), ("jacobi.jacobi5_general.tiling", 2048, 4.4e11, 0.3)]
    for key, size, rate, acc in rows:
        d = dict(variant=f"{key}.{size}", cells_per_s=rate, gflops=rate * 10 / 1e9, recorded_utc="2026-10-17 12:00:00Z",
                 model=dict(model_accuracy=acc, vpu_utilization=0.1, flop_utilization=0.1, hardware="x"),
                 card="NVIDIA H100 80GB HBM3, 700.00 W")
        (tmp_path / f"metrics.{key}.{size}.json").write_text(json.dumps(d))
    return str(tmp_path)


def _size_table(md: str) -> list[str]:
    lines = md.splitlines()
    start = next(i for i, line in enumerate(lines) if line.startswith("| series | 512^2"))
    return lines[start: lines.index("", start)]


def test_curves_match_jax(tmp_path):
    """The same series and GCell/s cells as JAX's renderer from the same
    files; the port flags a share above 1.05 (1.2 here), JAX one outside
    [0.5, 1.3] (0.3 here)."""
    d = _metrics_dir(tmp_path)
    got, want = curves.collect(d), jcurves.collect(d)
    assert {k: sorted(v) for k, v in got.items()} == {k: sorted(v) for k, v in want.items()}
    md = curves.render_markdown(got, "NVIDIA H100 80GB HBM3, 700.00 W")
    assert _size_table(md) == _size_table(jcurves.render_markdown(want))
    assert "on NVIDIA H100 80GB HBM3, 700.00 W" in md and "TPU" not in md
    flagged = [line for line in md.splitlines() if "(!)" in line]
    assert len(flagged) == 1 and flagged[0].startswith("| hotspot.tiling | 1024^2")


def test_curves_cli(tmp_path, capsys):
    assert curves.main([_metrics_dir(tmp_path)]) == 0
    assert "on NVIDIA H100 80GB HBM3, 700.00 W" in capsys.readouterr().out
    assert curves.main([str(tmp_path / "empty")]) == 1


def test_tables_match_jax():
    """JAX's details dict: the same GCell/s cells; the port flags the row
    whose share of the bound is above 1.05, and the failed case."""
    details = {
        "results": [
            {"case": "jacobi_tiling", "app": "jacobi5_general", "backend": "tiling", "grid": [8192, 8192],
             "n_iterations": 32768, "gcells_per_s": 176.8, "gflops": 1591.0, "vs_baseline": 1.004,
             "model": {"model_accuracy": 0.97}},
            {"case": "hotspot_monotile", "app": "hotspot", "backend": "monotile", "grid": [1024, 1024],
             "n_iterations": 131072, "gcells_per_s": 169.2, "gflops": 2538.0, "vs_baseline": 1.38,
             "model": {"model_accuracy": 4.13}},
            {"case": "convection_tiling", "app": "convection", "grid": [3072, 1024], "gcells_per_s": 11.9,
             "gflops": 595.0, "with_err": False},
        ],
        "convection_tiling_error": "ValueError: boom",
        "card": "NVIDIA H100 80GB HBM3, 700.00 W",
    }
    got, want = tables.render_rows(details), jtables.render_rows(details)
    cells = [line.split(" | ")[1] for line in got.splitlines()[2:] if "GCell/s" in line.split(" | ")[1]]
    assert cells == [line.split(" | ")[1] for line in want.splitlines()[2:] if "GCell/s" in line.split(" | ")[1]]
    assert len(cells) == 3 and "176.08 GCell/s" in got and "**1.00×**" in got
    assert got.count("ABOVE THE BOUND") == 1 and "4.13" in got and "FAILED: ValueError: boom" in got
    assert "shared-memory-resident" in got and "NVIDIA H100 80GB HBM3, 700.00 W" in got and "v5e" not in got
    assert "3072×1024, k=3, 11-field cells, tiling, lean Err" in got


# -- profiling hooks ------------------------------------------------------------------


def test_trace_writes_a_chrome_trace(tmp_path):
    """The port's spans go into the trace as complete events beside the
    profiler's, on its clock, and are off again after the block."""
    from stencilstream_tpu_torch import Grid, Params, create_update, tracing
    from stencilstream_tpu_torch.models import hotspot

    grid = Grid(hotspot.HotspotCell(temp=torch.full((16, 32), 80.0), power=torch.zeros(16, 32)))
    update = create_update(Params(transition_function=hotspot.derive_coefficients(16, 32), n_iterations=2,
                                  blocking=True), backend="tiling")
    with profile.trace(str(tmp_path)) as where:
        update(grid)
    assert not tracing.on and tracing.collect() == []
    events = json.loads(Path(where, "trace.json").read_text())["traceEvents"]
    call = [e for e in events if e.get("name") == "entry.call"]
    assert len(call) == 1 and call[0]["ph"] == "X" and call[0]["args"]["backend"] == "tiling"
    ops = [e for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    assert ops and all(call[0]["ts"] <= e["ts"] <= call[0]["ts"] + call[0]["dur"] for e in ops)


def test_trace_cells_takes_profiled_from_the_bench():
    from stencilstream_tpu_torch import trace_cells

    assert trace_cells.profiled is profile.profiled
    _, kernels, other = profile.profiled(lambda: torch.ones(4) + 1)
    assert kernels == {} and other == {}  # no device on the host


# -- the CLI ------------------------------------------------------------------------


def _cli(*args, cwd=REPO):
    return subprocess.run([sys.executable, "-m", "stencilstream_tpu_torch.bench", *args], capture_output=True,
                          text=True, cwd=cwd, timeout=600)


def test_max_perf_writes_metrics(tmp_path):
    """``tests/test_bench_cli.py``'s run on the port, on the CPU."""
    proc = _cli("max_perf", "jacobi", "--backend", "reference", "--device", "cpu", "--size", "64",
                "--n-iterations", "4", "--samples", "1", "--variant", "jacobi2_constant", "--out-dir", str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    assert "Walltime:" in proc.stdout
    metrics = list(tmp_path.glob("metrics.*.json"))
    assert [m.name for m in metrics] == ["metrics.jacobi.jacobi2_constant.reference.64.json"]
    data = json.loads(metrics[0].read_text())
    assert data["grid_shape"] == [64, 64] and data["cells_per_s"] > 0
    assert "model_accuracy" in data["model"] and data["card"] == "cpu: plain versions, host clock"


def test_without_a_card_the_default_device_refuses(tmp_path):
    """``--device cuda`` (the default) exits non-zero with a message, and
    runs nothing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = _cli("max_perf", "hotspot", "--size", "64", "--out-dir", str(tmp_path))
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    assert not list(tmp_path.glob("*.json")) and "Walltime" not in proc.stdout


@pytest.mark.parametrize("flag", [["--unroll", "2"], ["--shift-impl", "roll"], ["--vmem-budget", "1000"],
                                  ["--window-mode", "extended"]], ids=lambda f: f[0] + " " + f[1])
def test_tpu_flags_are_not_taken(flag, capsys):
    with pytest.raises(SystemExit) as e:
        pmain.main(["max_perf", "hotspot", "--device", "cpu", *flag])
    assert e.value.code == 2


def test_strong_scaling_and_tiling_on_the_host(tmp_path):
    """``strong_scaling`` on the host: one position, through ``distributed``;
    ``max_perf`` of FDTD through ``tiling``: its kernel stats; the output
    directory is made when missing."""
    tmp_path = tmp_path / "metrics"
    kw = ["--device", "cpu", "--n-iterations", "4", "--samples", "1", "--out-dir", str(tmp_path)]
    assert pmain.main(["strong_scaling", "hotspot", "--size", "64", *kw]) == 0
    assert pmain.main(["max_perf", "fdtd", "--size", "34", *kw]) == 0
    dist = json.loads((tmp_path / "metrics.hotspot.distributed.64.n1.json").read_text())
    fdtd = json.loads((tmp_path / "metrics.fdtd.tiling.34.json").read_text())
    assert dist["kernel"]["backend"] == "distributed" and dist["kernel"]["config"]["mesh"] == [1, 1]
    assert fdtd["kernel"]["kernel"] == "tile_pass" and fdtd["kernel"]["launches"] == 1
    assert fdtd["cell_bytes"] == 32 and fdtd["flops_per_cell"] == 22


def test_bench_imports_no_jax():
    code = ("import sys, stencilstream_tpu_torch.bench, stencilstream_tpu_torch.bench.__main__, "
            "stencilstream_tpu_torch.bench.curves, stencilstream_tpu_torch.bench.tables; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'stencilstream_tpu' "
            "or m.startswith('stencilstream_tpu.')]; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
