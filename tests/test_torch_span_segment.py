"""The traced run's span segment (``benchmark/span_segment.py``) and the six
metrics that read it: known answers on synthetic spans, device intervals
and launch events, and a traced run of a small cell on the CPU.

The test marked ``gpu`` holds the spans' clock against the profiler's on
the card (``python -m pytest --noconftest -m gpu
tests/test_torch_span_segment.py``). This file imports no JAX.
"""

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import span_segment  # noqa: E402
from benchmark.run import run_cell  # noqa: E402
from benchmark.spec import Spec  # noqa: E402

from stencilstream_tpu_torch import tracing  # noqa: E402

US = 1000  # the synthetic times below are in us; the module's are in ns
NEW = {"entry.host_ms_to_launch", "backends.span_host_ms_per_call", "kernels.enqueue_us_per_launch",
       "backends.plan_idle_ms_per_call", "models.check_idle_ms_per_call", "backends.exchange_mb_per_call"}
#: Small cells beside the real ones, with their chips: HotSpot on the tile
#: pass, Jacobi5 on ``auto`` (a new run every 3 calls), Jacobi5 in four
#: row slabs on ``distributed`` (two passes a call, each exchanging 6 strips
#: of 8 rows of 48 float32 cells).
CELLS = {
    "test-hot": ("hotspot", 1, {"height": 512, "width": 64, "n_iterations": 16, "backend": "tiling",
                                "options": {}, "calls_per_run": 0}),
    "test-jac": ("jacobi5", 1, {"height": 40, "width": 72, "n_iterations": 6, "backend": "auto",
                                "options": {}, "calls_per_run": 3}),
    "test-mesh": ("jacobi5_mesh", 4, {"height": 64, "width": 48, "n_iterations": 16, "backend": "distributed",
                                      "options": {"iters_per_pass": 8}, "calls_per_run": 0, "mesh": [4, 1]}),
}


@pytest.fixture
def test_root(tmp_path):
    """A copy of ``BENCHMARK.json`` and ``benchmark/`` with the small
    cells, as new files and new entries."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    for name, (config, chips, traffic) in CELLS.items():
        bench["workloads"].append({"name": name, "config": config, "traffic": name, "chips": chips, "why": "a test"})
        (tmp_path / "benchmark" / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
        (tmp_path / "benchmark" / "workloads" / f"{name}.json").write_text(
            json.dumps({"limits": {"chain_err": 1e-4, "sample_err": 1e-4}}))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


@pytest.fixture(autouse=True)
def spans_off():
    tracing.disable()
    tracing.collect()
    yield
    tracing.disable()
    tracing.collect()


def _spans(*rows):
    return [(name, s * US, e * US) for name, s, e in rows]


def _read(name, segment):
    return Spec().reader(name)({"span_segment": segment})


#: One benchmark call (0-1000 us) as a convection timestep makes it: two
#: user calls inside a block, then a check and its readback, all under the
#: timestep; and a second call (1000-2000 us) of one user call.
CONVECTION_LIKE = _spans(
    ("models.step", 5, 995), ("models.block", 10, 400),
    ("entry.call", 20, 200), ("kernels.launch", 30, 80), ("kernels.enqueue", 40, 60), ("entry.sync", 90, 190),
    ("entry.call", 210, 390), ("kernels.launch", 220, 260), ("kernels.enqueue", 230, 250), ("entry.sync", 270, 380),
    ("models.check", 400, 600), ("models.readback", 450, 590), ("models.thermal", 600, 990),
    ("entry.call", 1100, 1500), ("kernels.launch", 1150, 1200), ("kernels.enqueue", 1160, 1190),
    ("entry.sync", 1300, 1490),
)
CALLS = [(0, 1000 * US), (1000 * US, 2000 * US)]


def test_each_span_belongs_to_the_benchmark_call_it_falls_in():
    """Not to its ``entry.call``: the first call holds two, and its host time
    leaves out both synchronizes and the readback (1000 - 100 - 110 - 140
    us); its first launch ends 60 us in. The second: 1000 - 190 and 190."""
    free = span_segment.reduce_free(CALLS, CONVECTION_LIKE)
    assert free["calls"] == 2
    assert free["to_launch_ms"] == pytest.approx([0.06, 0.19])
    assert free["host_ms"] == pytest.approx([0.65, 0.81])
    assert free["enqueue_us"] == pytest.approx([20.0, 20.0, 30.0])


@pytest.mark.parametrize("metric, value", [
    ("entry.host_ms_to_launch", 0.125),
    ("backends.span_host_ms_per_call", 0.73),
    ("kernels.enqueue_us_per_launch", 20.0),
])
def test_the_host_readings_are_medians_over_the_unprofiled_calls(metric, value):
    assert _read(metric, {"free": span_segment.reduce_free(CALLS, CONVECTION_LIKE), "profiled": None}) == \
        pytest.approx(value)


#: One profiled call (0-1200 us): auto's choice, the plan, one launch, the
#: synchronize, then a check and its readback outside the call.
PROFILED = _spans(
    ("entry.call", 0, 1000), ("backends.choose", 0, 100), ("backends.plan", 100, 300),
    ("kernels.launch", 300, 350), ("kernels.enqueue", 310, 340), ("entry.sync", 350, 1000),
    ("models.check", 1000, 1200), ("models.readback", 1050, 1190),
)
#: Card 0 idles 580 us, card 1 430 us.
BUSY = {0: [(320 * US, 900 * US), (1000 * US, 1040 * US)], 1: [(150 * US, 250 * US), (330 * US, 1000 * US)]}
#: The mean over the two cards of each card's idle time by innermost span.
IDLE = {"backends.choose": 100, "backends.plan": 150, "kernels.launch": 10, "kernels.enqueue": 15,
        "entry.sync": 50, "models.check": 40, "models.readback": 140}


def _profiled(busy=BUSY, launches=((325, 335),), counters=None, spans=PROFILED):
    return span_segment.reduce_profiled((0, 1200 * US), busy, spans, [(s * US, e * US) for s, e in launches], 1,
                                        counters or {})


def test_idle_time_goes_to_the_innermost_span_and_is_the_mean_over_the_cards():
    prof = _profiled()
    assert prof["idle_by_span"] == pytest.approx({k: v * US for k, v in IDLE.items()})
    assert prof["idle_ns"] == pytest.approx(505 * US) == pytest.approx(sum(prof["idle_by_span"].values()))
    assert prof["device"] is True
    assert list(prof["idle_by_span"]) == sorted(prof["idle_by_span"], key=lambda k: -prof["idle_by_span"][k])
    assert prof["spans"]["models.check"] == 1


@pytest.mark.parametrize("metric, value", [
    ("backends.plan_idle_ms_per_call", 0.25),   # choose 100 + plan 150 us
    ("models.check_idle_ms_per_call", 0.18),    # check 40 + readback 140 us
])
def test_the_idle_readings(metric, value):
    assert _read(metric, {"free": span_segment.reduce_free([], []), "profiled": _profiled()}) == pytest.approx(value)


def test_a_call_without_a_check_reads_no_check_idle():
    prof = _profiled(spans=PROFILED[:-2])
    assert prof["idle_by_span"]["outside the port"] == pytest.approx((160 + 200) / 2 * US)
    assert _read("models.check_idle_ms_per_call", {"free": None, "profiled": prof}) is None
    assert _read("backends.plan_idle_ms_per_call", {"free": None, "profiled": prof}) == pytest.approx(0.25)


def test_a_segment_that_never_completed_reads_no_idle_but_the_host_readings():
    segment = {"free": span_segment.reduce_free(CALLS, CONVECTION_LIKE), "profiled": None}
    for name in ("backends.plan_idle_ms_per_call", "models.check_idle_ms_per_call", "backends.exchange_mb_per_call"):
        assert _read(name, segment) is None
    assert _read("backends.span_host_ms_per_call", segment) == pytest.approx(0.73)
    assert all(_read(name, None) is None for name in NEW)
    off_card = {"free": span_segment.reduce_free(CALLS[:1], [x for x in CONVECTION_LIKE if x[0] != "kernels.enqueue"]),
                "profiled": None}
    assert off_card["free"]["host_ms"] and _read("backends.span_host_ms_per_call", off_card) is None


def test_without_device_intervals_the_idle_readings_read_nothing():
    """On the CPU the whole window is idle: that is host time, not the device's."""
    prof = _profiled(busy={None: []})
    assert prof["device"] is False and prof["idle_ns"] == 1200 * US
    assert _read("backends.plan_idle_ms_per_call", {"free": None, "profiled": prof}) is None


def test_the_exchange_reading_is_the_counters_delta_a_call():
    segment = {"free": None, "profiled": _profiled(counters={"distributed.exchange_bytes": 393_216_000})}
    assert _read("backends.exchange_mb_per_call", segment) == pytest.approx(393.216)
    assert _read("backends.exchange_mb_per_call", {"free": None, "profiled": _profiled()}) is None


def test_the_clock_check_holds_each_launch_in_its_enqueue_span():
    clock = _profiled()["span_clock"]
    assert clock == {"pairs": 1, "held": 1.0, "worst_ns": 0, "median_ns": 5.0 * US, "shift_ns": 0}


def test_spans_off_by_more_than_the_slack_are_moved_by_the_median_offset():
    """Three enqueue spans whose launches lie 30 us later: each would need
    20 us to hold its event; moved by 30 us, every span holds it, and the
    idle table is read on the moved spans."""
    spans = _spans(("kernels.enqueue", 100, 130), ("kernels.enqueue", 300, 330), ("kernels.enqueue", 500, 530))
    prof = span_segment.reduce_profiled((0, 600 * US), {None: []}, spans,
                                        [(140 * US, 150 * US), (340 * US, 350 * US), (540 * US, 550 * US)], 3, {})
    clock = prof["span_clock"]
    assert (clock["held"], clock["worst_ns"], clock["shift_ns"]) == (0.0, 20 * US, 30 * US)
    assert clock["after"]["held"] == 1.0 and clock["after"]["worst_ns"] == 0
    assert prof["idle_by_span"]["kernels.enqueue"] == 90 * US


def test_innermost_covers_the_window_once():
    stretches = span_segment.innermost(PROFILED, 0, 1200 * US)
    assert stretches[0] == (0, 100 * US, "backends.choose") and stretches[-1] == (1190 * US, 1200 * US, "models.check")
    assert all(a[1] == b[0] for a, b in zip(stretches, stretches[1:]))
    assert span_segment.innermost([], 0, 10) == [(0, 10, span_segment.OUTSIDE)]


@pytest.mark.parametrize("cell, exchange_mb", [("test-jac", None), ("test-mesh", 2 * 6 * 8 * 48 * 4 / 1e6)])
def test_a_traced_cpu_run_makes_the_segment_after_its_window(test_root, monkeypatch, cell, exchange_mb):
    """The run's record holds its window's segment (``trace``) and the span
    segment; every metric the benchmark had reads the first alone, as
    before. On the CPU no kernel is launched on a card, so of the new ones
    only the exchange's bytes of a grid in blocks have something to read.
    Afterwards spans are off and none are left."""
    seen = {}
    measure = span_segment._measure

    def keep(record, root):
        seen["record"], seen["root"] = record, root
        return measure(record, root)

    monkeypatch.setattr(span_segment, "_measure", keep)
    spec = Spec(test_root)
    result = run_cell(spec, cell, 2**31 + 991, 0.3, True, device="cpu")
    record = seen["record"]
    segment = record["span_segment"]
    assert seen["root"] == test_root.resolve()
    assert result["correct"] is True and record["trace"]["complete"]
    assert segment["free"]["calls"] >= 1 and segment["profiled"]["calls"] >= 1
    assert len(segment["free"]["host_ms"]) == segment["free"]["calls"] and min(segment["free"]["host_ms"]) > 0
    window_only = {k: v for k, v in record.items() if k != "span_segment"}
    for m in spec.metrics(True):
        if m["name"] not in NEW:
            value = spec.reader(m["name"])(window_only)
            assert (value is None and m["name"] not in result["metrics"]) or \
                value == result["metrics"][m["name"]]["value"]
    assert NEW & set(result["metrics"]) == ({"backends.exchange_mb_per_call"} if exchange_mb else set())
    if exchange_mb:
        assert result["metrics"]["backends.exchange_mb_per_call"]["value"] == pytest.approx(exchange_mb)
    assert not tracing.on and tracing.collect() == []


def test_a_segment_that_fails_reads_nothing_and_leaves_spans_off(monkeypatch, capsys):
    """A launch that fails in the profiled stretch: the profiler stops, spans
    go off and are dropped, and every new metric reads nothing."""
    spans_on = []

    def update(grid):
        spans_on.append(tracing.on)
        if len(spans_on) > span_segment.WARMUP_CALLS:
            raise RuntimeError("a launch failed")
        return grid

    monkeypatch.setattr(span_segment, "_build", lambda record, root: (update, object(), [torch.device("cpu")], False))
    record = {"window_s": 1.0, "traffic": {}}
    assert span_segment.read(record, __file__) is None and record["span_segment"] is None
    assert spans_on == [False, False, True]
    assert "a launch failed" in capsys.readouterr().err
    assert all(Spec().reader(name)(record) is None for name in NEW)
    assert not tracing.on and tracing.collect() == []


@pytest.mark.gpu
def test_on_the_card_each_launch_event_lies_inside_its_enqueue_span():
    """The span segment of ``hotspot-8192`` (one second a stretch): after
    ``tracing.to_unix_ns``, at least 99% of the profiled launches fall inside
    their ``kernels.enqueue`` spans, with no move."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spec = Spec()
    cell = spec.cell("hotspot-8192")
    record = {"config": spec.config(cell["config"]), "traffic": spec.traffic(cell["traffic"]), "chips": 1,
              "peak_bytes": [1], "window_s": 3.0}
    segment = span_segment._measure(record, ROOT)
    clock = segment["profiled"]["span_clock"]
    assert clock["pairs"] == 25 * segment["profiled"]["calls"] and clock["held"] >= 0.99, clock
    assert min(segment["free"]["enqueue_us"]) > 0 and segment["profiled"]["idle_by_span"]["backends.plan"] > 0
    assert not tracing.on and tracing.collect() == []
