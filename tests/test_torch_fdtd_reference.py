"""The benchmark's FDTD cell on the CPU: its plain reference
(``benchmark/reference/fdtd.py``) against the port's updater, the app's
chained calls and their offsets, and the faults and the control that must
fail the cell's comparison. The benchmark's modules are loaded by path, as
the benchmark loads them (``benchmark.spec.load_module``)."""

import ast
import copy
import json
import math
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import axis  # noqa: E402
from benchmark.check import rel_err  # noqa: E402
from benchmark.faults import FAULTS, control  # noqa: E402
from benchmark.run import run_cell  # noqa: E402
from benchmark.spec import Spec, load_module  # noqa: E402

from stencilstream_tpu_torch.models import fdtd  # noqa: E402

BENCH = ROOT / "benchmark"
CONFIG = json.loads((BENCH / "configs" / "fdtd.json").read_text())
ref = load_module(BENCH / "reference" / "fdtd.py")
app = load_module(BENCH / "apps" / "fdtd.py")
CELL = "fdtd-2048"
LIMITS = json.loads((BENCH / "workloads" / f"{CELL}.json").read_text())["limits"]


def cut_config():
    """The configuration with its time axis cut (factors of tau), so that the
    source is strong at the cutoff: cutoff iteration 5470, detect 2735."""
    cfg = copy.deepcopy(CONFIG)
    cfg["experiment"]["time"].update(t_cutoff=0.2, t_detect=0.1)
    cfg["experiment"]["source"]["phase"] = 0.15
    return cfg


def random_cells(H, W, seed):
    """Seeded random fields and coefficients (no ring: every cell its own)."""
    gen = torch.Generator().manual_seed(seed)

    def u(lo, hi):
        return torch.rand(H, W, generator=gen) * (hi - lo) + lo

    fields = {"ex": u(-1, 1), "ey": u(-1, 1), "hz": u(-1, 1), "hz_sum": u(0, 1),
              "ca": u(0.9, 1.0), "cb": u(100.0, 300.0), "da": u(0.9, 1.0), "db": u(1e-4, 2e-4)}
    fields["iteration"] = torch.zeros(H, W)
    return fields


def test_cut_config_straddles():
    k = ref.constants(cut_config(), 48, 48)
    assert (k["cutoff"], k["detect"]) == (5470, 2735)


@pytest.mark.parametrize("backend", ["auto", "tiling"])
@pytest.mark.parametrize("grid", ["ring48", "random48x40"])
@pytest.mark.parametrize("which", ["cutoff", "detect"])
def test_port_matches_reference(backend, grid, which):
    """Eight iterations whose middle is the cutoff or the detect iteration."""
    cfg, n = cut_config(), 8
    if grid == "ring48":
        H, W = 48, 48
        fields, coefficients = app.make_inputs(H, W, 2**33 + 5, "cpu"), None
    else:
        H, W = 48, 40
        fields = random_cells(H, W, 11)
        coefficients = {k: fields[k] for k in ref.COEFFICIENTS}
    offset = ref.constants(cfg, H, W)[which] - n // 2 + 1
    fields["iteration"].fill_(offset)
    traffic = {"height": H, "width": W, "n_iterations": n, "backend": backend, "options": {}}
    out = app.from_grid(app.make_update(cfg, traffic)(app.to_grid(fields)))
    want = ref.run(fields, n, cfg, coefficients=coefficients)
    # float32 rounds each of a step's two sub-steps, about one unit in the
    # last place of the largest value each: room for two each
    assert rel_err(out, want) < n * 4 * 2.0**-23
    assert rel_err(out, want) > 0  # float32, not the float64 reference bit for bit
    assert int(out["iteration"][0, 0]) == offset + n and bool((out["iteration"] == offset + n).all())
    # the source and the accumulator switched inside the call
    sr, sc = ref.constants(cfg, H, W)["source"]
    if which == "detect":
        assert bool((want["hz_sum"] != fields["hz_sum"].double()).any())
    assert abs(float(want["hz"][sr, sc] - ref.run({**fields, "iteration": fields["iteration"] + 10**6}, n, cfg,
                                                  coefficients=coefficients)["hz"][sr, sc])) > 1e-3


def _tiled_inputs(grid, n):
    """A case of :func:`test_port_matches_reference` whose call straddles the
    cutoff: (fields, coefficients, offset, traffic) for ``n`` iterations."""
    cfg = cut_config()
    if grid == "ring48":
        H, W = 48, 48
        fields, coefficients = app.make_inputs(H, W, 2**33 + 7, "cpu"), None
    else:
        H, W = 48, 40
        fields = random_cells(H, W, 13)
        coefficients = {k: fields[k] for k in ref.COEFFICIENTS}
    offset = ref.constants(cfg, H, W)["cutoff"] - n // 2 + 1
    fields["iteration"].fill_(offset)
    return cfg, fields, coefficients, {"height": H, "width": W, "n_iterations": n, "backend": "tiling"}


@pytest.mark.parametrize("p", [None, 4, 5, 6, 7, 8], ids=lambda p: f"p{p or 'law'}")
@pytest.mark.parametrize("grid", ["ring48", "random48x40"])
def test_tiling_in_the_kernels_geometry_matches_reference(grid, p):
    """Through ``tiling`` the CPU runs the kernel's geometry for FDTD, whose
    functor declares its one-sided reach: each tile from its own window, its
    core and a halo of p a side, each sub-step narrowed by its reach
    (``tile_pass.tile_pass_plain`` given the tile). At the law's p and at p = 4-8, over 19
    iterations (the last pass partial), the cells match the float64
    reference as in :func:`test_port_matches_reference`."""
    from stencilstream_tpu_torch.backends import tile_pass as tp

    n = 19
    cfg, fields, coefficients, traffic = _tiled_inputs(grid, n)
    options = {} if p is None else {"iters_per_pass": p}
    launches = tp.launches
    out = app.from_grid(app.make_update(cfg, {**traffic, "options": options})(app.to_grid(fields)))
    want = ref.run(fields, n, cfg, coefficients=coefficients)
    assert 0 < rel_err(out, want) < n * 4 * 2.0**-23
    assert tp.launches == launches  # the plain version, no kernel


def test_a_halo_one_short_of_the_reach_fails_the_reference(monkeypatch):
    """The same call with the tile pass's halo one short of the reach summed
    over the pass (p - 1): the tiles' edge cells keep values from before the
    pass's last sub-steps, and the comparison fails by far."""
    from stencilstream_tpu_torch.backends import tile_pass as tp

    n = 19
    cfg, fields, coefficients, traffic = _tiled_inputs("random48x40", n)
    want = ref.run(fields, n, cfg, coefficients=coefficients)
    real = tp.pass_halo
    monkeypatch.setattr(tp, "pass_halo", lambda *a: real(*a) - 1)
    out = app.from_grid(app.make_update(cfg, {**traffic, "options": {"iters_per_pass": 4}})(app.to_grid(fields)))
    assert rel_err(out, want) > 1e3 * max(LIMITS.values())


def test_cutoff_and_detect_switch_where_the_configuration_says():
    """Beside the rest of the update, the source adds to one cell only up to
    the cutoff, and hz_sum grows only after the detect iteration."""
    cfg = cut_config()
    k = ref.constants(cfg, 48, 48)
    zeros = {f: torch.zeros(48, 48) for f in ("ex", "ey", "hz", "hz_sum")}

    def hz_after(offset, n):
        return ref.run({**zeros, "iteration": torch.full((48, 48), float(offset))}, n, cfg)

    past = hz_after(k["cutoff"] + 1, 3)
    assert float(past["hz"].abs().max()) == 0.0
    last = hz_after(k["cutoff"], 1)
    assert float(last["hz"].abs().max()) == abs(float(last["hz"][k["source"]])) > 0
    # cutoff 5470 > detect 2735: hz_sum is on, and holds the one cell's hz^2
    assert float(last["hz_sum"].sum()) == pytest.approx(float(last["hz"][k["source"]]) ** 2)
    early = hz_after(k["detect"], 1)
    assert float(early["hz_sum"].abs().max()) == 0.0
    late = hz_after(k["detect"] + 1, 1)
    assert float(late["hz_sum"][k["source"]]) == pytest.approx(float(late["hz"][k["source"]]) ** 2)


def test_time_axis_and_geometry_of_the_configuration():
    """The reference's own derivation gives the published axis at 2048^2, as
    the port's ``Parameters`` does, and the stored ring radius is the rule's."""
    k = ref.constants(CONFIG, 2048, 2048)
    traffic = json.loads((BENCH / "traffic" / "sq2048-n2736-auto-r150.json").read_text())
    assert (k["cutoff"], k["detect"], k["n_snap"], k["source"]) == (191482, 382965, 2736, (1024, 1024))
    assert k["radius"] == CONFIG["experiment"]["cavity_rings"][0]["radius"]
    p = app.parameters(CONFIG, 2048, 2048)
    kernel = fdtd.make_kernel(p, fdtd.CoefResolver(p))
    assert (kernel.cutoff_iteration, kernel.detect_iteration) == (k["cutoff"], k["detect"])
    assert p.n_snap_timesteps() == k["n_snap"] == traffic["n_iterations"]
    assert traffic["calls_per_run"] * traffic["n_iterations"] >= p.n_timesteps() == 410321
    assert p.dt() == k["dt"]


@pytest.mark.parametrize("shape", [(48, 48), (40, 72), (2048, 2048)])
def test_app_planes_are_the_references_derivation(shape):
    fields = app.make_inputs(*shape, 3, "cpu")
    planes = ref.material_planes(CONFIG, *shape)
    assert all(torch.equal(fields[k], planes[k]) for k in planes)
    assert float(planes["cb"].max()) == pytest.approx(263.72467, rel=1e-6)
    assert float(planes["ca"].min()) == 0.0  # the corners lie beyond the ring
    assert list(app.from_grid(app.to_grid(fields)))[0] == "ex"


def test_inputs_follow_the_seed():
    a, b, c = (app.make_inputs(32, 32, s, "cpu") for s in (2**33 + 1, 2**33 + 1, 2**33 + 2))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["ex"], c["ex"])
    assert all(-1 <= float(a[k].min()) and float(a[k].max()) <= 1 for k in ("ex", "ey", "hz"))
    assert float(a["hz_sum"].abs().max()) == 0.0 and float(a["iteration"].abs().max()) == 0.0


def test_chained_calls_and_a_restart_carry_the_offset():
    """Three chained calls equal the reference's 3n iterations, offset plane
    included; a restart from the initial grid starts the time axis again."""
    cfg, n = cut_config(), 6
    traffic = {"height": 48, "width": 48, "n_iterations": n, "backend": "auto", "options": {}}
    fields = app.make_inputs(48, 48, 17, "cpu")
    fields["iteration"].fill_(ref.constants(cfg, 48, 48)["detect"] - 8)  # the second call crosses detect
    update = app.make_update(cfg, traffic)
    initial = app.to_grid(fields)
    grid = initial
    for _ in range(3):
        grid = update(grid)
    out = app.from_grid(grid)
    assert rel_err(out, ref.run(fields, 3 * n, cfg)) < 3 * n * 4 * 2.0**-23
    assert float(out["iteration"][0, 0]) == float(fields["iteration"][0, 0]) + 3 * n
    again = app.from_grid(update(initial))
    first = ref.run(fields, n, cfg)
    assert rel_err(again, first) < n * 4 * 2.0**-23
    assert torch.equal(again["iteration"].double(), first["iteration"])
    assert torch.equal(fields["ex"], app.from_grid(initial)["ex"])  # the input is never modified


@pytest.fixture
def small_root(tmp_path):
    """A copy of the benchmark with ``fdtd-48``: the cell at 48^2, six
    iterations a call, a new simulation every three calls, under the limits
    of the real cell."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "fdtd-48", "config": "fdtd", "traffic": "fdtd-48", "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = {"height": 48, "width": 48, "n_iterations": 6, "backend": "auto", "options": {}, "calls_per_run": 3}
    (tmp_path / "benchmark" / "traffic" / "fdtd-48.json").write_text(json.dumps(traffic))
    (tmp_path / "benchmark" / "workloads" / "fdtd-48.json").write_text(json.dumps({"limits": LIMITS}))
    return tmp_path


def _run(root, wrap=None):
    return run_cell(Spec(root), "fdtd-48", 2**31 + 4321, 0.4, False, device="cpu", wrap=wrap)


def test_the_cell_runs_correct_on_the_cpu(small_root):
    result = _run(small_root)
    assert result["correct"] is True and result["attempted"] > 3  # the window restarts its simulation
    assert all(0 <= c["value"] < c["limit"] / 10 for c in result["checks"].values())


@pytest.mark.parametrize("wrong", sorted(FAULTS) + ["control_bf16"])
def test_faults_and_the_control_fail(small_root, wrong):
    spec = Spec(small_root)
    if wrong == "control_bf16":
        wrap = control(spec.reference("fdtd"), spec.config("fdtd"), spec.traffic("fdtd-48"))
    else:
        wrap = FAULTS[wrong]
    result = _run(small_root, wrap)
    assert result["correct"] is False
    assert max(c["value"] / c["limit"] for c in result["checks"].values()) >= 4


def _ring_edge_dropped(cell):
    """The outermost cells of the ring lose their coefficients."""
    inside = cell.cb > 0
    pad = torch.nn.functional.pad(inside[None, None].float(), (1, 1, 1, 1))[0, 0]
    edge = inside & ((pad[:-2, 1:-1] + pad[2:, 1:-1] + pad[1:-1, :-2] + pad[1:-1, 2:]) < 4)
    for name in ref.COEFFICIENTS:
        getattr(cell, name)[edge] = 0.0


COEFFICIENT_FAULTS = {
    "cb_scaled": lambda cell: cell.cb.mul_(1.001),
    "db_scaled": lambda cell: cell.db.mul_(1.001),
    "ring_edge_dropped": _ring_edge_dropped,
}


@pytest.mark.parametrize("wrong", sorted(COEFFICIENT_FAULTS) + ["ca_overwritten"])
def test_wrong_coefficients_fail(small_root, monkeypatch, wrong):
    """The reference derives the coefficients itself: a port that initialised
    one wrongly, or overwrites one, fails the comparison."""
    wrap = None
    if wrong == "ca_overwritten":
        def wrap(update, app):
            def call(grid):
                out = update(grid)
                out.arrays.ca[out.arrays.ca > 0] *= 0.999
                return out
            return call
    else:
        init_grid = fdtd.init_grid

        def wrong_init(*args, **kwargs):
            grid = init_grid(*args, **kwargs)
            COEFFICIENT_FAULTS[wrong](grid.arrays)
            return grid

        monkeypatch.setattr(fdtd, "init_grid", wrong_init)
    result = _run(small_root, wrap)
    assert result["correct"] is False
    assert max(c["value"] / c["limit"] for c in result["checks"].values()) >= 4


def test_reference_reads_no_coefficient_plane_of_the_state():
    fields = app.make_inputs(48, 48, 29, "cpu")
    wrong = {**fields, **{k: torch.zeros(48, 48) for k in ref.COEFFICIENTS}}
    a, b = ref.run(fields, 3, CONFIG), ref.run(wrong, 3, CONFIG)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(a[k], ref.material_planes(CONFIG, 48, 48)[k].double()) for k in ref.COEFFICIENTS)


@pytest.mark.parametrize("wrong", [None, "answer_altered"])
def test_whole_axis_check(small_root, wrong):
    """``benchmark.axis`` on the small cell with its axis cut so that calls
    2 and 3 cross the cutoff (iteration 9) and the detect switch (14)."""
    cfg = copy.deepcopy(CONFIG)
    step = ref.constants(cfg, 48, 48)["dt"] / cfg["experiment"]["tau"]
    cfg["experiment"]["time"].update(t_cutoff=9.5 * step, t_detect=14.5 * step)
    (small_root / "benchmark" / "configs" / "fdtd.json").write_text(json.dumps(cfg))
    k = ref.constants(cfg, 48, 48)
    assert (k["cutoff"], k["detect"]) == (9, 14)
    records = axis.check_axis(Spec(small_root), "fdtd-48", 2**32 + 77, [1, 2, 3, 4], 4, device="cpu",
                              wrap=FAULTS[wrong] if wrong else None)
    assert [(r["frame"], r["iteration"]) for r in records] == [(1, 0), (2, 6), (3, 12), (4, 18)]
    if wrong:
        assert all(r["err"] >= 4 * LIMITS["sample_err"] for r in records)
    else:
        assert all(0 < r["err"] < LIMITS["sample_err"] / 10 for r in records)


def test_reference_imports_nothing_of_the_packages():
    tree = ast.parse((BENCH / "reference" / "fdtd.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "math", "numpy", "torch"}
    assert not names & {"stencilstream_tpu", "stencilstream_tpu_torch", "jax", "benchmark"}


def test_tdv_device_time_reader():
    """Device kernels that are neither the port's kernels nor copies or
    fills, a traced call."""
    read = load_module(BENCH / "metrics" / "backends.tdv_device_us_per_call.py").read
    kernels = {"void ss::tile_pass_kernel<ss::FdtdCoefOp>(...)": {"us": 9000.0, "seen": 30},
               "void at::native::vectorized_elementwise_kernel<4, cos>(...)": {"us": 40.0, "seen": 2},
               "Memcpy DtoD (Device -> Device)": {"us": 20.0, "seen": 2},
               "Memset (Device)": {"us": 6.0, "seen": 2}}
    trace = {"calls": 2, "kernels": kernels, "launches": {"tile_pass": 30, "line_cache": 0, "monotile": 0}}
    assert read({"config": CONFIG, "trace": trace}) == pytest.approx(20.0)
    assert read({"config": {k: v for k, v in CONFIG.items() if k != "tdv"}, "trace": trace}) is None
    assert read({"config": CONFIG, "trace": None}) is None
    assert read({"config": CONFIG, "trace": dict(trace, kernels={})}) is None
    assert math.isfinite(read({"config": CONFIG, "trace": dict(trace, kernels={k: v for k, v in kernels.items()
                                                                          if "tile_pass" in k})}))
