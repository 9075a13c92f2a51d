"""The port's spans (``stencilstream_tpu_torch.tracing``): what a call
records, the off path, and the profiler's clock.

On the CPU the kernel wrappers run their plain versions, so a call records
every span but ``kernels.enqueue``; the test marked ``gpu`` checks that one
on the card (``python -m pytest --noconftest -m gpu
tests/test_torch_tracing.py``). This file imports no JAX.
"""

import ast
import statistics
from pathlib import Path

import numpy as np
import pytest
import torch

from stencilstream_tpu_torch import Grid, Params, create_update, tdv, tracing
from stencilstream_tpu_torch.models import convection, fdtd, hotspot
from stencilstream_tpu_torch.parallel import make_mesh

STAGES = ["entry.call", "entry.check_no_grad", "backends.plan", "backends.tdv"]


@pytest.fixture(autouse=True)
def spans_off():
    """Every test starts and ends with spans off and none recorded."""
    tracing.disable()
    tracing.collect()
    yield
    tracing.disable()
    tracing.collect()


def _grid(H, W, device="cpu"):
    gen = torch.Generator().manual_seed(H * W)
    temp = torch.rand(H, W, generator=gen) * 20 + 70
    power = torch.rand(H, W, generator=gen) * 1e-3
    return Grid(hotspot.HotspotCell(temp=temp.to(device), power=power.to(device)))


def _update(grid, backend, n, **kw):
    tf = hotspot.derive_coefficients(grid.height, grid.width)
    return create_update(Params(transition_function=tf, n_iterations=n, blocking=True), backend=backend, **kw)


def _traced(update, grid):
    tracing.enable()
    out = update(grid)
    tracing.disable()
    return out, tracing.collect()


def _check_nesting(spans):
    """Each span lies inside its parent, and shares its parent's call."""
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            parent = spans[s.parent]
            assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns
            assert s.call == parent.call


@pytest.mark.parametrize("mode, kernel", [("clamped", "tile_pass"), ("linecache", "line_cache")])
def test_a_tiling_call_records_its_passes(mode, kernel):
    """n = 2p + 1: one call, three passes with indices 0-2, one call id."""
    grid = _grid(32, 64)
    _, spans = _traced(_update(grid, "tiling", 5, iters_per_pass=2, window_mode=mode), grid)
    names = [s.name for s in spans]
    assert names == STAGES + ["kernels.launch"] * 3 + ["entry.sync"]
    call = spans[0]
    assert call.parent is None and call.attrs == {"backend": "tiling", "H": 32, "W": 64, "n": 5}
    assert all(s.parent == 0 for s in spans[1:])
    assert len({s.call for s in spans}) == 1 and call.call is not None
    launches = [s for s in spans if s.name == "kernels.launch"]
    # A tile pass's span carries its halo: HotSpot declares no reach, so r*p*k = 2.
    halo = {"halo": 2} if kernel == "tile_pass" else {}
    assert [s.attrs for s in launches] == [{"kernel": kernel, "pass_index": i, **halo} for i in range(3)]
    assert spans[2].attrs["geometry"]["iters_per_pass"] == 2
    assert spans[3].attrs == {"strategy": "InlineTDV", "offset": 0, "n": 5}
    _check_nesting(spans)


@pytest.mark.parametrize("shape, chosen, kernel", [((32, 64), "monotile", "monotile"),
                                                   ((16, 8192), "tiling", "tile_pass")])
def test_auto_records_its_choice(shape, chosen, kernel):
    """One ``entry.call`` (the delegate's call opens none) and the backend
    ``auto`` chose."""
    grid = _grid(*shape)
    update = _update(grid, "auto", 1)
    _, spans = _traced(update, grid)
    assert update.resolved_backend == chosen
    assert [s.name for s in spans if s.name == "entry.call"] == ["entry.call"]
    assert spans[0].attrs["backend"] == "auto"
    choose = [s for s in spans if s.name == "backends.choose"]
    assert len(choose) == 1 and choose[0].attrs == {"backend": chosen} and choose[0].parent == 0
    assert [s.attrs["kernel"] for s in spans if s.name == "kernels.launch"] == [kernel]
    assert {s.name for s in spans} == set(STAGES) | {"backends.choose", "kernels.launch", "entry.sync"}
    _check_nesting(spans)


def test_each_call_has_its_own_id_and_collect_forgets():
    grid = _grid(32, 64)
    update = _update(grid, "monotile", 2)
    tracing.enable()
    update(update(grid))
    spans = tracing.collect()
    assert tracing.collect() == []
    calls = [s for s in spans if s.name == "entry.call"]
    assert len(calls) == 2 and calls[0].call != calls[1].call
    second = spans.index(calls[1])
    assert all(s.call == calls[1].call for s in spans[second:])
    assert spans[second + 1].parent == second  # parents index the list collected


def test_a_span_outside_a_call_belongs_to_none():
    tracing.enable()
    with tracing.span("outer", tag=1) as outer:
        with tracing.span("inner"):
            pass
    spans = tracing.collect()
    assert [(s.name, s.parent, s.call) for s in spans] == [("outer", None, None), ("inner", 0, None)]
    assert outer is spans[0] and outer.attrs == {"tag": 1}


def test_disable_keeps_what_was_recorded():
    grid = _grid(32, 64)
    update = _update(grid, "tiling", 1)
    tracing.enable()
    update(grid)
    tracing.disable()
    update(grid)
    assert [s.name for s in tracing.collect()].count("entry.call") == 1


@pytest.mark.parametrize("backend", ["tiling", "monotile", "auto"])
def test_spans_off_read_no_clock(monkeypatch, backend):
    """Off, a call never reads the spans' clock and records nothing."""
    def no_clock():
        raise AssertionError("the spans' clock was read with spans off")

    monkeypatch.setattr(tracing, "clock", no_clock)
    grid = _grid(32, 64)
    out = _update(grid, backend, 3)(grid)
    assert out.shape == (32, 64)
    assert tracing.collect() == []


def test_a_span_lands_beside_a_record_function_on_the_profilers_timeline():
    """Opened back to back, a port span and a ``record_function`` start
    within 50 us of each other once the span's time goes through
    ``to_unix_ns``, the profiler's host timeline."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tracing.enable()
        for _ in range(20):
            with tracing.span("probe"):
                with torch.profiler.record_function("probe.rf"):
                    torch.ones(4).sum()
        tracing.disable()
    origin = prof.profiler.kineto_results.trace_start_ns()
    marks = sorted(origin + e.time_range.start * 1e3 for e in prof.events() if e.name == "probe.rf")
    spans = [tracing.to_unix_ns(s.start_ns) for s in tracing.collect()]
    assert len(marks) == len(spans) == 20
    gaps = [abs(m - s) / 1e3 for m, s in zip(marks, spans)]
    assert statistics.median(gaps) < 50, gaps


def _fdtd(n, offset):
    """FDTD's cut mono-benchmark at 64^2 (source on, detect passed), on the
    CPU, its call's ``iteration_offset`` set as the snapshot loop sets it."""
    p = fdtd.Parameters.from_json(fdtd.mono_benchmark(64))
    update, resolver = fdtd.build_simulation(p, backend="tiling", n_iterations=n, iters_per_pass=2)
    update.get_params().iteration_offset = offset
    return update, fdtd.init_grid(p, resolver, device="cpu")


@pytest.mark.parametrize("strategy", ["inline", "precompute_on_host"])
def test_an_fdtd_call_counts_its_tdv_stream(strategy):
    """One call: one ``backends.tdv`` span, which carries the stream's offset
    and its n values; two calls, two spans of 10 values in all."""
    update, grid = _fdtd(5, 3000)
    update.get_params().tdv_strategy = strategy
    _, spans = _traced(update, grid)
    [span] = [s for s in spans if s.name == "backends.tdv"]
    assert span.attrs["offset"] == 3000 and span.attrs["n"] == 5
    assert span.attrs["strategy"] == type(tdv.resolve_tdv_strategy(strategy)).__name__
    assert update._tdv_stream(grid).shape == (5,)
    _, more = _traced(update, grid)
    assert sum(s.attrs["n"] for s in spans + more if s.name == "backends.tdv") == 10


def test_a_call_without_a_tdv_counts_none():
    """The call's span is there, but the strategy evaluates no stream."""
    grid = _grid(32, 64)
    update = _update(grid, "auto", 4)
    _, spans = _traced(update, grid)
    assert [s.attrs for s in spans if s.name == "backends.tdv"] == [{"strategy": "InlineTDV", "offset": 0, "n": 4}]
    assert update._delegate_for(update.resolved_backend)._tdv_stream(grid) is None


def test_no_module_counts_launches_but_the_kernels():
    """The benchmark takes a port module's integer ``launches`` for a kernel
    module (``ss::<module>_kernel``): the TDV counters are named otherwise,
    and the modules that count launches stay these five."""
    package = Path(tdv.__file__).parent
    counting = set()
    for path in package.rglob("*.py"):
        for node in ast.parse(path.read_text()).body:
            targets = node.targets if isinstance(node, ast.Assign) else [getattr(node, "target", None)]
            if any(isinstance(t, ast.Name) and t.id == "launches" for t in targets):
                counting.add(str(path.relative_to(package)))
    assert counting == {"backends/tile_pass.py", "backends/line_cache.py", "backends/monotile.py",
                        "experiments/strip.py", "experiments/linecache.py"}
    assert not hasattr(tdv, "launches")


def _convection_step():
    """A convection ``Simulation`` at res 8 (a 24x8 grid), nerr 5, iterMax
    20 and an epsilon no timestep reaches, and its initial grid."""
    e = convection.Experiment(lx=3.0, ly=1.0, px=1.5, py=0.5, eta0=1.0, DcT=1.0, deltaT=1.0, Ra=1e7, Pra=1e3,
                              res=8, iterMax=20, nt=1, nout=1, nerr=5, epsilon=1e-12, dmp=2.0)
    return convection.Simulation(e, np.float64), convection.init_grid(e, np.float64, device="cpu")


def test_a_convection_step_records_its_blocks_checks_and_thermal_step():
    """One step: one ``models.step``; iterMax / nerr ``models.block`` and
    ``models.check`` spans in turns, each check holding one
    ``models.readback``, and one ``models.thermal``, all nested under it;
    each block's two updates and the thermal one open their own calls
    inside them. ``convection.pt_iterations`` advances by iterMax."""
    sim, grid = _convection_step()
    before = convection.pt_iterations
    _, spans = _traced(sim.step, grid)
    assert convection.pt_iterations - before == 20
    models = [(i, s) for i, s in enumerate(spans) if s.name.startswith("models.")]
    assert [s.name for _, s in models] == (["models.step"] + ["models.block", "models.check", "models.readback"] * 4
                                           + ["models.thermal"])
    step = models[0][1]
    assert step.parent is None and step.call is None
    checks = {i for i, s in models if s.name == "models.check"}
    for i, s in models[1:]:
        assert s.parent in (checks if s.name == "models.readback" else {0}) and s.call is None
        assert spans[s.parent].start_ns <= s.start_ns <= s.end_ns <= spans[s.parent].end_ns
    calls = [s for s in spans if s.name == "entry.call"]
    assert [spans[s.parent].name for s in calls] == ["models.block"] * 8 + ["models.thermal"]
    assert len({s.call for s in calls}) == 9 and all(spans[s.parent].start_ns <= s.start_ns for s in calls)
    # the maxima run outside the port's calls: a check holds its readback alone
    assert [spans[s.parent].name for s in spans if s.parent in checks] == ["models.check"] * 4
    assert all(s.name == "models.readback" for s in spans if s.parent in checks)


def test_a_convection_step_with_spans_off_records_nothing():
    sim, grid = _convection_step()
    before = convection.pt_iterations
    sim.step(grid)
    assert tracing.collect() == []
    assert convection.pt_iterations - before == 20


@pytest.mark.parametrize("devices, exchanges", [(["cpu"] * 4, 0), ([f"cpu:{i}" for i in range(4)], 25)])
def test_a_ring_call_records_its_plan_and_each_exchange(devices, exchanges):
    """A ring of four positions, p = 2, two laps of 8 chunks of 6 rows: one
    ``backends.plan`` a call with its geometry; between positions on
    different devices, a lap's ``backends.exchange`` spans are each chunk
    sent on by positions 0-2 (passes 4 lap + 0..2, one field) and the root
    taking the lap back (pass 4 lap + 3, both fields and the 2 * 2 look
    rows). On one device nothing is exchanged."""
    grid = _grid(48, 32)
    update = _update(grid, "ring", 16, mesh=make_mesh(shape=(4,), devices=devices), iters_per_pass=2)
    out, spans = _traced(update, grid)
    [plan] = [s for s in spans if s.name == "backends.plan"]
    assert plan.attrs["geometry"] == update.resolved_config and plan.attrs["geometry"]["chunk_rows"] == 6
    found = [s.attrs for s in spans if s.name == "backends.exchange"]
    assert len(found) == 2 * exchanges
    for lap in range(2 if exchanges else 0):
        mine = [a for a in found if a["pass_index"] // 4 == lap]
        assert sorted(a["pass_index"] % 4 for a in mine) == [0] * 8 + [1] * 8 + [2] * 8 + [3]
        assert {a["bytes"] for a in mine if a["pass_index"] % 4 < 3} == {6 * 32 * 4}
        assert [a["bytes"] for a in mine if a["pass_index"] % 4 == 3] == [2 * (48 + 4) * 32 * 4]
    _check_nesting(spans)
    plain = _update(grid, "reference", 16)(grid)
    assert torch.equal(out.arrays.temp, plain.arrays.temp)


@pytest.mark.gpu
def test_a_call_on_the_card_records_each_enqueue():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    grid = _grid(64, 128, "cuda")
    _, spans = _traced(_update(grid, "tiling", 5, iters_per_pass=2), grid)
    launches = [i for i, s in enumerate(spans) if s.name == "kernels.launch"]
    enqueues = [s for s in spans if s.name == "kernels.enqueue"]
    assert len(launches) == 3 and [s.parent for s in enqueues] == launches
    assert spans[-1].name == "entry.sync"
    _check_nesting(spans)
