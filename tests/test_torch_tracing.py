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

import pytest
import torch

from stencilstream_tpu_torch import Grid, Params, create_update, tdv, tracing
from stencilstream_tpu_torch.models import fdtd, hotspot

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
    """One call: one stream evaluated, n values; the span carries both."""
    update, grid = _fdtd(5, 3000)
    update.get_params().tdv_strategy = strategy
    before = (tdv.evaluations, tdv.values)
    _, spans = _traced(update, grid)
    assert (tdv.evaluations - before[0], tdv.values - before[1]) == (1, 5)
    [span] = [s for s in spans if s.name == "backends.tdv"]
    assert span.attrs["offset"] == 3000 and span.attrs["n"] == 5
    update(grid)  # spans off: the counters count all the same
    assert (tdv.evaluations - before[0], tdv.values - before[1]) == (2, 10)


def test_a_call_without_a_tdv_counts_none():
    grid = _grid(32, 64)
    before = (tdv.evaluations, tdv.values)
    _, spans = _traced(_update(grid, "auto", 4), grid)
    assert (tdv.evaluations, tdv.values) == before
    assert [s.attrs for s in spans if s.name == "backends.tdv"] == [{"strategy": "InlineTDV", "offset": 0, "n": 4}]


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
    assert isinstance(tdv.evaluations, int) and not hasattr(tdv, "launches")


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
