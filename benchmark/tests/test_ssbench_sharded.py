"""A cell whose grid is in blocks over its cards, run on the CPU with every
block on ``cpu``: HotSpot at 96 x 80, n = 3 a call, mesh [2, 2] on four
chips, through ``sharded_hotspot.py`` (the port's ``distributed`` backend
on a mesh of CPU devices).

The test configuration's chip is cut to 96 x 80 cells of a 40960-row chip's
size, so that a cell couples to each neighbour by Cap_1 Ry_1 = 0.22 an
iteration, as at that size (stable below 0.25): what crosses a block's edge
in a few iterations shows in the numbers compared. At 96 x 80 cells of
Rodinia's 16 mm chip the coupling is ~1e-6, and a cut's reach is gone after
two iterations."""

import functools
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from benchmark import run as bench_run
from benchmark import trace as tracing
from benchmark.check import compare, margin, run_checks
from benchmark.faults import FAULTS
from benchmark.layout import Layout, mesh_of
from benchmark.pin import pin, visible_cards
from benchmark.roofline import bound_s, peak_for
from benchmark.spec import ROOT, Spec
from stencilstream_tpu_torch.models import hotspot as port_hotspot

from conftest import TEST_LIMITS

HERE = Path(__file__).resolve().parent
CELL, H, W = "test-sharded", 96, 80
#: Rodinia's 16 mm chip in cells of a 40960 x 40960 grid, cut to 96 x 80 of them.
CHIP = (96 * 0.016 / 40960, 80 * 0.016 / 40960)
TRAFFIC = {"height": H, "width": W, "n_iterations": 3, "backend": "distributed", "options": {},
           "calls_per_run": 0, "mesh": [2, 2]}


def add_sharded_cell(root: Path, name: str = CELL, traffic: dict = TRAFFIC, chips: int = 4, **config_keys) -> None:
    """The configuration ``hotspot_sharded`` (HotSpot's, with ``sub_steps``
    and the test chip), its app and reference, and a cell of it."""
    cfg = json.loads((root / "benchmark/configs/hotspot.json").read_text())
    cfg.update(name="hotspot_sharded", sub_steps=1)
    cfg["constants"].update(chip_height=CHIP[0], chip_width=CHIP[1])
    cfg.update(config_keys)
    cfg = {k: v for k, v in cfg.items() if v is not None}
    (root / "benchmark/configs/hotspot_sharded.json").write_text(json.dumps(cfg))
    shutil.copy(HERE / "sharded_hotspot.py", root / "benchmark/apps/hotspot_sharded.py")
    shutil.copy(root / "benchmark/reference/hotspot.py", root / "benchmark/reference/hotspot_sharded.py")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "hotspot_sharded", "source": "https://example.org", "reduced": [],
                             "file": "benchmark/configs/hotspot_sharded.json", "why": "a test"})
    bench["workloads"].append({"name": name, "config": "hotspot_sharded", "traffic": name, "chips": chips,
                               "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "benchmark/traffic" / f"{name}.json").write_text(json.dumps(traffic))
    (root / "benchmark/workloads" / f"{name}.json").write_text(json.dumps({"limits": TEST_LIMITS}))


@pytest.fixture
def sharded_root(test_root, monkeypatch):
    """The small cells' copy of the benchmark with the sharded cell; the
    port's HotSpot derives its coefficients from the same test chip."""
    monkeypatch.setattr(port_hotspot, "CHIP_HEIGHT", CHIP[0])
    monkeypatch.setattr(port_hotspot, "CHIP_WIDTH", CHIP[1])
    add_sharded_cell(test_root)
    return test_root


def _run(root, cell=CELL, wrap=None, seed=2**31 + 977):
    return bench_run.run_cell(Spec(root), cell, seed, 0.3, False, device="cpu", wrap=wrap)


@pytest.fixture
def checked(sharded_root, monkeypatch):
    """One run of the sharded cell, with what its check was handed and
    every input the reference ran on."""
    seen = {}

    def recording_checks(reference, config, traffic, kept, layout, inputs, **kw):
        shapes = []
        real_run = reference.run

        @functools.wraps(real_run)
        def run(fields, *a, **k):
            shapes.append(tuple(fields["temp"].shape))
            return real_run(fields, *a, **k)

        reference.run = run
        seen.update(reference=reference, config=config, traffic=traffic, kept=kept, layout=layout,
                    inputs=inputs, shapes=shapes)
        return run_checks(reference, config, traffic, kept, layout, inputs, **kw)

    monkeypatch.setattr(bench_run, "run_checks", recording_checks)
    seen["result"] = _run(sharded_root)
    return seen


def _whole(blocks: dict) -> dict:
    """The blocks of one kept grid as one grid."""
    keys = sorted(blocks)
    return {name: torch.cat([torch.cat([blocks[k][name] for k in keys if k[0] == iy], dim=1)
                             for iy in sorted({k[0] for k in keys})], dim=0)
            for name in blocks[keys[0]]}


def test_the_cell_runs_in_blocks(checked):
    result, kept, layout = checked["result"], checked["kept"], checked["layout"]
    assert result["correct"] is True and result["device"]["count"] == 4
    assert set(layout.blocks) == {(0, 0), (0, 1), (1, 0), (1, 1)}
    for name in ("chain", "sample_in", "sample_out"):
        for key, (rows, cols, _) in layout.blocks.items():
            assert kept[name][key]["temp"].shape == (len(rows), len(cols)) == (48, 40)
    # the reference never ran on the whole grid: each block widened by 6 (chain) or 3 (sample), clipped
    assert sorted(set(checked["shapes"])) == [(51, 43), (54, 46)]
    assert all(0 < v["value"] <= v["limit"] for v in result["checks"].values())


def test_the_blocked_check_reads_the_whole_checks_numbers(checked):
    """The same kept data, whole on one device: the numbers are equal bit for bit."""
    layout, kept = checked["layout"], checked["kept"]
    whole = Layout(H, W, (1, 1), [torch.device("cpu")])
    whole_kept = {name: {(0, 0): _whole(kept[name])} for name in ("chain", "sample_in", "sample_out")}
    whole_kept["chain_calls"] = kept["chain_calls"]
    inputs = _whole({key: checked["inputs"](key) for key in layout.blocks})
    numbers = run_checks(checked["reference"], checked["config"], checked["traffic"], whole_kept, whole,
                         lambda key: inputs)
    assert numbers == {k: v["value"] for k, v in checked["result"]["checks"].items()}


def test_a_margin_one_row_short_reads_otherwise(checked):
    ref, config, layout, kept = checked["reference"], checked["config"], checked["layout"], checked["kept"]
    n = checked["traffic"]["n_iterations"] * kept["chain_calls"]
    m = margin(config, n)
    assert m == 6
    right = compare(ref, config, n, layout, checked["inputs"], kept["chain"], m)
    assert right == checked["result"]["checks"]["chain_err"]["value"]
    assert compare(ref, config, n, layout, checked["inputs"], kept["chain"], m + 5) == right
    assert compare(ref, config, n, layout, checked["inputs"], kept["chain"], m - 1) != right


def test_a_cell_altered_next_to_a_block_boundary_fails(sharded_root):
    def wrap(update, app):
        def call(grid):
            out = update(grid)
            out.arrays.temp[47, 39] += 1.0  # the last row and column of block (0, 0)
            return out

        return call

    result = _run(sharded_root, wrap=wrap)
    assert result["correct"] is False
    assert result["checks"]["chain_err"]["value"] > result["checks"]["chain_err"]["limit"]


@pytest.mark.parametrize("fault", ["unchanged", "half_left_out"])
def test_faults_act_on_every_block(sharded_root, fault):
    assert _run(sharded_root, wrap=FAULTS[fault])["correct"] is False


def test_every_share_reckons_the_cells_chips():
    spec = Spec()
    config, peak = spec.config("hotspot"), peak_for(spec.peaks(), "NVIDIA H100 80GB HBM3")
    traffic = {"height": 65536, "width": 65536, "n_iterations": 200}
    one, four = bound_s(config, traffic, peak), bound_s(config, traffic, peak, 4)
    assert four == (one[0] / 4, one[1])
    trace = {"calls": 2, "launches": {"tile_pass": 8},
             "kernels": {"void ss::tile_pass_kernel<ss::HotspotOp>(...)": {"us": 8000.0, "seen": 8}}}
    assert tracing.kernel_ms_per_call(trace, 4) == tracing.kernel_ms_per_call(trace) / 4 == 1.0
    record = {"chips": 4, "bound_s": 1e-3, "trace": trace}
    assert spec.reader("kernels_roofline")(record) == pytest.approx(100.0)
    # peak_mem_gib: the largest over the cards of each card's peak less its kept grids
    assert spec.reader("peak_mem_gib")({"peak_bytes": [10 * 2**30, 20 * 2**30],
                                        "kept_bytes": [2 * 2**30, 15 * 2**30]}) == 8.0


def _profile(device_events, spans=((0.0, 100.0),)):
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def event(kind, s, e, name, card=0):
        return SimpleNamespace(device_type=kind, name=name, device_index=card,
                               time_range=SimpleNamespace(start=s, end=e))

    events = [event(cpu, s, e, tracing.CALL_SPAN) for s, e in spans]
    events += [event(cpu, 60.0, 70.0, "cudaLaunchKernel")]
    events += [event(cuda, s, e, name, card) for s, e, name, card in device_events]
    return SimpleNamespace(events=lambda: events)


def test_a_two_card_trace_reads_each_cards_idle_share():
    kernel = "void ss::tile_pass_kernel<ss::HotspotOp>(...)"
    prof = _profile([(0.0, 30.0, kernel, 0), (40.0, 70.0, kernel, 0), (10.0, 30.0, kernel, 1)])
    t = tracing.reduce(prof, {"tile_pass": 0}, {"tile_pass": 3}, cards=[0, 1])
    assert t["busy_us_by_card"] == {0: 60.0, 1: 20.0} and t["busy_us"] == 40.0
    assert t["kernels"][kernel] == {"us": 80.0, "seen": 3}
    # the idle gaps are card 1's, the idler: 30..100 first, then 0..10
    assert [g[1] for g in t["idle_gaps"]] == [70e-6, 10e-6]
    idle = Spec().reader("device.idle_share")({"trace": t})
    assert idle == pytest.approx((40.0 + 80.0) / 2)
    # a card of the run that ran nothing is idle throughout
    t3 = tracing.reduce(prof, {"tile_pass": 0}, {"tile_pass": 3}, cards=[0, 1, 2])
    assert t3["busy_us_by_card"][2] == 0.0
    assert Spec().reader("device.idle_share")({"trace": t3}) == pytest.approx((40.0 + 80.0 + 100.0) / 3)
    # without cards, every interval is one card's, as on one card
    t1 = tracing.reduce(prof, {"tile_pass": 0}, {"tile_pass": 3})
    assert t1["busy_us"] == 60.0 and list(t1["busy_us_by_card"].values()) == [60.0]


@pytest.mark.parametrize("chips,current,want", [
    (1, None, "0"), (4, None, "0,1,2,3"), (1, "3,5", "3"), (2, "GPU-a, GPU-b,GPU-c", "GPU-a,GPU-b"),
    (4, "2,3", "2,3"), (1, "", ""),
])
def test_the_pins_value(chips, current, want):
    assert visible_cards(chips, current) == want


def test_pin_takes_the_cells_chips():
    env = {}
    pin(["--workload", "hotspot-8192", "--seed", "1"], env)
    assert env == {"CUDA_VISIBLE_DEVICES": "0"}
    env = {"CUDA_VISIBLE_DEVICES": "6,7"}
    pin(["--workload=hotspot-1024"], env)
    assert env == {"CUDA_VISIBLE_DEVICES": "6"}
    env = {"CUDA_VISIBLE_DEVICES": "6,7"}
    pin(["--workload", "no-such-cell"], env)
    pin(["--seed", "1"], env)
    assert env == {"CUDA_VISIBLE_DEVICES": "6,7"}


@pytest.mark.parametrize("module", ["benchmark.run", "benchmark.spans"])
@pytest.mark.parametrize("current,want", [(None, "0"), ("5,6", "5")])
def test_the_entry_points_pin_before_torch(module, current, want):
    """Run as a program, the module sets the variable before ``torch`` is
    imported (here, without a card, it then exits with an error)."""
    code = ("import os, runpy, sys\n"
            f"sys.argv = ['x', '--workload', 'hotspot-8192', '--seed', '1', '--seconds', '1']\n"
            "seen = []\n"
            "class Finder:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name == 'torch': seen.append(os.environ.get('CUDA_VISIBLE_DEVICES'))\n"
            "sys.meta_path.insert(0, Finder())\n"
            f"try:\n    runpy.run_module({module!r}, run_name='__main__', alter_sys=True)\n"
            "except SystemExit:\n    pass\n"
            "print(seen[0])\n")
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    if current is not None:
        env["CUDA_VISIBLE_DEVICES"] = current
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, env=env,
                          timeout=120)
    assert proc.stdout.strip().splitlines()[-1] == want, proc.stderr[-2000:]


def test_a_layout_other_than_the_cells_chips_is_refused(sharded_root):
    assert mesh_of({}, 1) == (1, 1)
    for mesh, chips in (([2, 2], 1), ([1, 2], 4), ([2, 0], 0), ([4], 4), ("2x2", 4), ([2.0, 2], 4)):
        with pytest.raises(ValueError):
            mesh_of({"mesh": mesh}, chips)
    with pytest.raises(ValueError, match="empty"):
        Layout(9, 8, (4, 1), ["cpu"] * 4)  # rows of 3: the fourth block would hold none
    add_sharded_cell(sharded_root, "test-sharded-2", dict(TRAFFIC, mesh=[1, 2]), chips=4)
    with pytest.raises(ValueError, match="mesh"):
        _run(sharded_root, "test-sharded-2")


def test_a_sharded_config_without_sub_steps_is_refused(sharded_root):
    add_sharded_cell(sharded_root, sub_steps=None)
    with pytest.raises(ValueError, match="sub_steps"):
        _run(sharded_root)


def test_a_reference_without_origin_and_extent_checks_one_block_only(sharded_root):
    shutil.copy(sharded_root / "benchmark/reference/jacobi5.py", sharded_root / "benchmark/reference/hotspot_sharded.py")
    with pytest.raises(ValueError, match="origin and extent"):
        _run(sharded_root)


def test_the_hotspot_reference_in_blocks():
    """By default the reference runs today's arithmetic; a block with the
    grid's extent reads the grid's own values where the cut is far enough."""
    spec = Spec()
    cfg, ref = spec.config("hotspot"), spec.reference("hotspot")
    gen = torch.Generator().manual_seed(3)
    fields = {"temp": torch.rand(40, 36, generator=gen) * 20 + 70, "power": torch.rand(40, 36, generator=gen) * 1e-3}
    whole = ref.run(fields, 4, cfg)
    assert torch.equal(ref.run(fields, 4, cfg, origin=(0, 0), extent=(40, 36))["temp"], whole["temp"])
    block = ref.run({k: v[10:30, 8:36] for k, v in fields.items()}, 4, cfg, origin=(10, 8), extent=(40, 36))
    assert torch.equal(block["temp"][4:16, 4:], whole["temp"][14:26, 12:])
    with pytest.raises(ValueError):
        ref.run({k: v[10:30] for k, v in fields.items()}, 1, cfg, origin=(30, 0), extent=(40, 36))
