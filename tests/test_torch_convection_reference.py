"""The benchmark's convection cell on the CPU: its plain reference
(``benchmark/reference/convection.py``) against the port's timestep
(``convection.Simulation``), the app's chained calls and its guard, the
control, the port's float32 path and the faults that must fail the cell's
comparison, and ``run`` as a loop over ``Simulation.step``. The benchmark's
modules are loaded by path, as the benchmark loads them
(``benchmark.spec.load_module``). Grids are res 8 (24x8) and res 16
(48x16), with nerr 5 and iterMax 20-40."""

import ast
import copy
import dataclasses
import json
import re
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.check import rel_err  # noqa: E402
from benchmark.faults import FAULTS, control  # noqa: E402
from benchmark.run import run_cell  # noqa: E402
from benchmark.spec import Spec, load_module  # noqa: E402

from stencilstream_tpu_torch import Grid, Params, create_update, tracing  # noqa: E402
from stencilstream_tpu_torch.models import convection as pc  # noqa: E402

BENCH = ROOT / "benchmark"
CONFIG = json.loads((BENCH / "configs" / "convection.json").read_text())
TRAFFIC = json.loads((BENCH / "traffic" / "3072x1024-n400-auto.json").read_text())
ref = load_module(BENCH / "reference" / "convection.py")
app = load_module(BENCH / "apps" / "convection.py")
CELL = "convection-3072"
LIMITS = json.loads((BENCH / "workloads" / f"{CELL}.json").read_text())["limits"]
#: The port's backends on the CPU: the plain versions of the three kernels.
BACKENDS = {
    "auto": ("auto", {}),
    "tiling": ("tiling", {"iters_per_pass": 2}),
    "linecache": ("tiling", {"window_mode": "linecache", "strip_rows": 8}),
    "monotile": ("monotile", {}),
}


def cut_config(iter_max=20, epsilon=1e-12):
    """The configuration with nerr 5 and a short iterMax; an epsilon no
    timestep reaches in so few iterations, unless given."""
    cfg = copy.deepcopy(CONFIG)
    cfg["experiment"].update(nerr=5, iterMax=iter_max, epsilon=epsilon)
    return cfg


def traffic(res, cfg, backend="auto"):
    name, options = BACKENDS[backend]
    return {"height": 3 * res, "width": res, "n_iterations": cfg["experiment"]["iterMax"], "backend": name,
            "options": options, "calls_per_run": 0}


def test_reference_derives_the_experiments_numbers():
    """The reference's own derivation equals the port's ``Experiment`` at
    the cell's res and at a test's."""
    for res in (16, 1024):
        e = app.experiment(CONFIG, 3 * res, res)
        k = ref.constants(CONFIG, 3 * res, res)
        assert (k["nx"], k["ny"]) == (e.nx, e.ny) == (3 * res - 1, res - 1)
        for name in ("dx", "dy", "rho", "beta", "dampX", "dampY", "dt_diff"):
            assert k[name] == getattr(e, name), name
        assert (k["dtau"], k["g"], k["dedT"]) == (e.delta_tau_iter, e.roh0_g_alpha, e.delta_eta_delta_T)
    assert (TRAFFIC["height"], TRAFFIC["width"]) == (3 * 1024, 1024)
    assert TRAFFIC["n_iterations"] == CONFIG["experiment"]["iterMax"] == 8 * CONFIG["experiment"]["nerr"]


@pytest.mark.parametrize("shape", [(40, 72), (48, 17)])
def test_a_grid_that_is_not_three_to_one_takes_its_own_size(shape):
    """A grid of any shape, as the benchmark's own tests run every
    configuration (40x72 for 40 iterations): ``nx`` and ``ny`` are the
    grid's in the app and the reference alike, and an ``n`` below
    ``iterMax`` is one timestep capped at ``n``, in one block."""
    H, W = shape
    e, k = app.experiment(CONFIG, H, W), ref.constants(CONFIG, H, W)
    assert (k["nx"], k["ny"]) == (e.nx, e.ny) == (H - 1, W - 1)
    assert (k["dx"], k["dy"], k["dtau"]) == (e.dx, e.dy, e.delta_tau_iter) == (k["dx"], 1.0 / (W - 2), k["dtau"])
    fields = app.make_inputs(H, W, 2**32 + H, "cpu")
    update = app.make_update(CONFIG, {"height": H, "width": W, "n_iterations": 40, "backend": "auto", "options": {},
                                      "calls_per_run": 0})
    tracing.collect()
    tracing.enable()
    try:
        out = app.from_grid(update(app.to_grid(fields)))
    finally:
        tracing.disable()
    assert sum(s.name == "models.block" for s in tracing.collect()) == 1
    assert 0 < rel_err(out, ref.run(fields, 40, CONFIG)) < 40 * 3 * 8 * 2.0**-52


def test_inputs_follow_the_seed():
    a, b, c = (app.make_inputs(48, 16, s, "cpu") for s in (2**33 + 1, 2**33 + 1, 2**33 + 2))
    assert list(a) == list(pc.FIELDS) and all(v.dtype == torch.float64 for v in a.values())
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(not torch.equal(a[k], c[k]) for k in a)
    e = app.experiment(CONFIG, 48, 16)
    T0 = pc.init_grid(e, np.float64, device="cpu").arrays.T
    # the plates and the cells beyond the active region keep upstream's values
    assert torch.equal(a["T"][:, 0], T0[:, 0]) and torch.equal(a["T"][:, e.ny - 1], T0[:, e.ny - 1])
    assert torch.equal(a["T"][e.nx], T0[e.nx]) and torch.equal(a["T"][:, e.ny], T0[:, e.ny])
    inside = (a["T"] - T0)[: e.nx, 1: e.ny - 1]
    assert 0 < float(inside.abs().max()) <= app.T_NOISE * e.deltaT
    assert all(0 < float(a[k].abs().min()) and float(a[k].abs().max()) <= app.FIELD_NOISE for k in pc.FIELDS[1:])


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("res, iter_max", [(8, 30), (16, 20)])
def test_port_step_matches_reference(backend, res, iter_max):
    """Two timesteps of the port's plain versions against the float64
    reference on seeded random fields. The kernels fuse multiply-adds and
    multiply by reciprocals where the reference rounds a product and a
    quotient apart: an ulp or so a sub-step, which the damped
    pseudo-transient iteration does not amplify; 8 ulps of each of the 3
    sub-steps of every iteration is room enough (measured: ~1e-14)."""
    cfg = cut_config(iter_max)
    fields = app.make_inputs(3 * res, res, 2**31 + res, "cpu")
    update = app.make_update(cfg, traffic(res, cfg, backend))
    grid = app.to_grid(fields)
    out = app.from_grid(update(update(grid)))
    want = ref.run(fields, 2 * iter_max, cfg)
    assert 0 < rel_err(out, want) < 2 * iter_max * 3 * 8 * 2.0**-52
    assert all(torch.equal(fields[k], v) for k, v in app.from_grid(grid).items())  # the input is never modified


@pytest.mark.parametrize("epsilon, iters", [(1e-12, 40), (1e3, 5)])
def test_the_step_runs_the_convergence_rule(epsilon, iters):
    """A timestep ends after the first block whose errV and errP are at
    most epsilon, or at iterMax: the port and the reference stop at the
    same block."""
    cfg = cut_config(40, epsilon)
    fields = app.make_inputs(24, 8, 7, "cpu")
    sim = pc.Simulation(app.experiment(cfg, 24, 8), np.float64)
    out = app.from_grid(sim.step(app.to_grid(fields)))
    assert sim.stats["iters"] == iters
    assert (max(sim.stats["errV"], sim.stats["errP"]) <= epsilon) == (iters < 40)
    assert rel_err(out, ref.run(fields, 40, cfg)) < iters * 3 * 8 * 2.0**-52


def test_a_timestep_that_converges_early_raises():
    cfg = cut_config(20, epsilon=1e3)
    update = app.make_update(cfg, traffic(8, cfg))
    with pytest.raises(RuntimeError, match="ran 5 pseudo-transient iterations, not 20"):
        update(app.to_grid(app.make_inputs(24, 8, 3, "cpu")))
    with pytest.raises(ValueError, match="one timestep"):
        app.make_update(cfg, dict(traffic(8, cfg), n_iterations=40))


def test_dt_changed_between_two_thermal_calls_changes_the_result():
    """The thermal updater a ``Simulation`` made once reads ``dt`` at each
    call: a second call with another ``dt`` equals a fresh updater's."""
    e = app.experiment(cut_config(), 48, 16)
    sim = pc.Simulation(e, np.float64, False, "tiling")
    grid = app.to_grid(app.make_inputs(48, 16, 11, "cpu"))
    thermal = sim.thermal_update
    thermal.get_params().transition_function.dt = np.float64(1e-6)
    first = thermal(grid).arrays.T
    thermal.get_params().transition_function.dt = np.float64(3e-6)
    second = thermal(grid).arrays.T
    fresh = create_update(Params(pc.make_thermal_kernel(e, np.float64, dt=3e-6), halo_value=pc.zero_cell()),
                          backend="tiling")(grid).arrays.T
    assert torch.equal(second, fresh) and not torch.equal(first, second)
    # through a step: dt is the adaptive rule's, written before the thermal step
    sim.step(grid)
    assert thermal.get_params().transition_function.dt == np.float64(sim.stats["dt"]) != np.float64(3e-6)


def _parents_run(e, backend, dtype, folded):
    """The timestep loop of ``run`` as it stood before ``Simulation``,
    without its printing, timing and frames: ``(grid, stats)``."""
    halo = pc.folded_zero_cell() if folded else pc.zero_cell()
    use_lean = e.nerr > 1 and (folded or backend != "reference")
    make_pt = pc.make_folded_pseudo_transient_kernel if folded else pc.make_pseudo_transient_kernel

    def update(tf, n, halo, **params):
        return create_update(Params(transition_function=tf, halo_value=halo, n_iterations=n, **params),
                             backend=backend)

    pt_update = update(make_pt(e, dtype, with_err=True), 1 if use_lean else e.nerr, halo, blocking=True)
    lean_update = update(make_pt(e, dtype, with_err=False), e.nerr - 1, halo, blocking=True) if use_lean else None
    thermal_update = update(pc.make_thermal_kernel(e, dtype), 1, pc.zero_cell())
    grid = (pc.init_folded_grid if folded else pc.init_grid)(e, dtype, device="cpu")
    stats = []
    for it in range(1, e.nt + 1):
        errV = errP = 2 * e.epsilon
        max_vals = (0.0,) * 5
        iters = 0
        while iters < e.iterMax and (errV > e.epsilon or errP > e.epsilon):
            if lean_update is not None:
                grid = lean_update(grid)
            grid = pt_update(grid)
            iters += e.nerr
            max_ErrV, max_ErrP, max_Vx, max_Vy, max_Pt = pc._error_maxes(grid.arrays, e.nx, e.ny)
            errV = max_ErrV / (1e-12 + max_Vy)
            errP = max_ErrP / (1e-12 + max_Pt)
            max_vals = (max_ErrV, max_ErrP, max_Vx, max_Vy, max_Pt)
        _, _, max_Vx, max_Vy, _ = max_vals
        dt = min(e.dt_diff, min(e.dx / max(max_Vx, 1e-300), e.dy / max(max_Vy, 1e-300)) / 2.1)
        thermal_update.get_params().transition_function.dt = dtype(dt)
        T = thermal_update(Grid(pc.physics_cell(grid.arrays))).arrays.T
        grid = Grid(dataclasses.replace(grid.arrays, T=T))
        stats.append({"it": it, "iters": iters, "errV": errV, "errP": errP, "dt": dt})
    return grid, stats


@pytest.mark.parametrize("backend, dtype, folded", [
    ("auto", np.float64, False), ("auto", np.float32, False), ("reference", np.float64, False),
    ("auto", np.float64, True),
])
def test_run_is_the_parents_loop_bit_for_bit(backend, dtype, folded, capsys):
    """``run`` over ``Simulation.step`` gives the grid and stats of the loop
    it replaced, and prints the same lines but for the times."""
    e = dataclasses.replace(app.experiment(cut_config(), 48, 16), nt=3, epsilon=5e-2)
    grid, info = pc.run(e, backend=backend, dtype=dtype, folded=folded, device="cpu")
    want, want_stats = _parents_run(e, backend, dtype, folded)
    assert info["stats"] == want_stats
    assert {s["iters"] for s in want_stats} != {e.iterMax}  # a timestep converged before iterMax
    for f in pc.FIELDS + (pc.PLANES if folded else ()):
        assert torch.equal(getattr(grid.arrays, f), getattr(want.arrays, f)), f
    lines = capsys.readouterr().out.splitlines()
    assert [re.sub(r"time = \S+\)", "", s) for s in lines[:3]] == [
        f"it = {s['it']} (iter = {s['iters']}, , errV={s['errV']:1.3e}, errP={s['errP']:1.3e}" for s in want_stats]
    assert lines[3].startswith("Total time = ") and "transient computation time" in lines[4]


@pytest.fixture
def small_root(tmp_path):
    """A copy of the benchmark with ``convection-24``: the cell at res 8,
    nerr 5, iterMax 20, one timestep a call, under the limits of the real
    cell."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "convection-24", "config": "convection", "traffic": "convection-24",
                               "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cfg = cut_config()
    (tmp_path / "benchmark" / "configs" / "convection.json").write_text(json.dumps(cfg))
    (tmp_path / "benchmark" / "traffic" / "convection-24.json").write_text(json.dumps(traffic(8, cfg)))
    (tmp_path / "benchmark" / "workloads" / "convection-24.json").write_text(json.dumps({"limits": LIMITS}))
    return tmp_path


def _run(root, wrap=None, seconds=0.4):
    return run_cell(Spec(root), "convection-24", 2**31 + 4321, seconds, False, device="cpu", wrap=wrap)


def test_the_cell_runs_correct_on_the_cpu(small_root):
    """Chained calls, one timestep each (one ``models.step`` span), every
    one of 20 iterations."""
    before = pc.pt_iterations
    tracing.collect()
    tracing.enable()
    try:
        result = _run(small_root)
    finally:
        tracing.disable()
    steps = sum(s.name == "models.step" for s in tracing.collect())
    assert result["correct"] is True and result["attempted"] >= 2
    assert all(0 < c["value"] < c["limit"] / 100 for c in result["checks"].values())
    calls = result["attempted"] + 2  # the warm-up's two
    assert (steps, pc.pt_iterations - before) == (calls, 20 * calls)


@pytest.mark.parametrize("wrong", sorted(FAULTS) + ["control_bf16", "port_float32"])
def test_faults_the_control_and_the_float32_path_fail(small_root, wrong):
    """Each fails the cell's limits by four times or more: the float32
    path, the precision below the configuration's, by far the least."""
    spec = Spec(small_root)
    config, cell_traffic = spec.config("convection"), spec.traffic("convection-24")
    if wrong == "control_bf16":
        wrap = control(spec.reference("convection"), config, cell_traffic)
    elif wrong == "port_float32":
        wrap = spec.app("convection").precision_below(config, cell_traffic)
    else:
        wrap = FAULTS[wrong]
    result = _run(small_root, wrap, seconds=0.2)
    assert result["correct"] is False
    assert max(c["value"] / c["limit"] for c in result["checks"].values()) >= 4


def test_reference_imports_nothing_of_the_packages():
    tree = ast.parse((BENCH / "reference" / "convection.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "math", "torch"}


def test_configuration_names_the_pseudo_transient_functors():
    """``pt_op_types`` are the C++ types of the float64 lean and full
    functors (``csrc/ops/all.cuh``), and the fields are the cell's."""
    table = dict(re.findall(r"X\((\w+), ss::(\w+)\)", (ROOT / "stencilstream_tpu_torch/csrc/ops/all.cuh").read_text()))
    e = app.experiment(CONFIG, 48, 16)
    ops = [pc.make_pseudo_transient_kernel(e, np.float64, with_err=w).cuda_op for w in (False, True)]
    assert CONFIG["pt_op_types"] == [table[op] for op in ops] == ["ConvectionPtLeanF64Op", "ConvectionPtF64Op"]
    assert tuple(CONFIG["fields"]) == pc.FIELDS and CONFIG["dtype"] == "float64"
    assert CONFIG["bytes_read_per_cell"] == CONFIG["bytes_written_per_cell"] == 8 * len(pc.FIELDS)


def test_the_readers_of_the_convection_cell():
    """``kernels.pt_roofline`` reads the pseudo-transient kernels alone;
    ``models.check_device_us_per_call`` the kernels that are neither the
    port's nor copies or fills. Both None in a configuration without them."""
    pt = load_module(BENCH / "metrics" / "kernels.pt_roofline.py").read
    check = load_module(BENCH / "metrics" / "models.check_device_us_per_call.py").read
    kernels = {"void ss::tile_pass_kernel<ss::ConvectionPtLeanF64Op, ss::TilePassArgs>(...)": {"us": 9000.0, "seen": 14},
               "void ss::tile_pass_kernel<ss::ConvectionPtF64Op, ss::TilePassArgs>(...)": {"us": 1000.0, "seen": 2},
               "void ss::tile_pass_kernel<ss::ConvectionThermalF64Op, ss::TilePassArgs>(...)": {"us": 400.0, "seen": 2},
               "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<double, MaxOps>>(...)": {"us": 60.0, "seen": 20},
               "void at::native::CatArrayBatchedCopy<double>(...)": {"us": 4.0, "seen": 2},
               "Memcpy DtoH (Device -> Pinned)": {"us": 20.0, "seen": 2},
               "Memset (Device)": {"us": 6.0, "seen": 2}}
    trace = {"calls": 2, "kernels": kernels, "launches": {"tile_pass": 18, "line_cache": 0, "monotile": 0}}
    record = {"config": CONFIG, "trace": trace, "bound_s": 2e-3}
    assert pt(record) == pytest.approx(2e-3 / 5e-3 * 100)
    assert check(record) == pytest.approx(32.0)
    other = {"config": {k: v for k, v in CONFIG.items() if k not in ("pt_op_types", "convergence_loop")},
             "trace": trace, "bound_s": 2e-3}
    assert pt(other) is None and check(other) is None
    assert pt(dict(record, trace=None)) is None and check(dict(record, trace=None)) is None
    assert check(dict(record, trace=dict(trace, kernels={}))) is None
