"""The port's spans in a traced run (``benchmark/spans.py``): the four
readings and the idle table on spans and device intervals with known
answers, and a traced run on the CPU whose record holds spans."""

from types import SimpleNamespace

import pytest
import torch

from benchmark import spans as bench_spans
from benchmark import trace as bench_trace
from benchmark.spec import Spec

US = 1000  # the synthetic times below are in us; the module's are in ns


def _span(name, start, end, call):
    return {"name": name, "start": start * US, "end": end * US, "call": call}


#: Two calls inside a profiled segment (0-1000 us; the device busy 100-300
#: and 500-900) and two after it, which no segment covers.
SPANS = [
    _span("entry.call", 10, 480, 1), _span("entry.check_no_grad", 20, 40, 1), _span("backends.plan", 40, 60, 1),
    _span("kernels.launch", 60, 120, 1), _span("kernels.enqueue", 80, 110, 1), _span("entry.sync", 130, 470, 1),
    _span("entry.call", 520, 990, 2), _span("kernels.launch", 530, 560, 2), _span("kernels.enqueue", 540, 550, 2),
    _span("entry.sync", 560, 985, 2),
    _span("entry.call", 2000, 2900, 3), _span("kernels.launch", 2050, 2200, 3),
    _span("kernels.enqueue", 2100, 2150, 3), _span("kernels.launch", 2250, 2350, 3),
    _span("kernels.enqueue", 2300, 2340, 3), _span("entry.sync", 2400, 2880, 3),
    _span("entry.call", 3000, 3500, 4), _span("kernels.launch", 3010, 3080, 4),
    _span("kernels.enqueue", 3050, 3070, 4), _span("entry.sync", 3100, 3450, 4),
]
SEGMENT = {"window": (0, 1000 * US), "calls": 2, "busy": [(100 * US, 300 * US), (500 * US, 900 * US)]}
#: The segment's 400 us of idle time by innermost span.
IDLE = {"entry.sync": 255, "outside the port": 40, "entry.call": 25, "entry.check_no_grad": 20,
        "backends.plan": 20, "kernels.launch": 20, "kernels.enqueue": 20}


def test_idle_by_innermost_span():
    by_name, in_calls = bench_spans.idle_by_span(SPANS, SEGMENT["window"], SEGMENT["busy"])
    assert by_name == {k: v * US for k, v in IDLE.items()}
    assert sum(by_name.values()) == 400 * US and in_calls == 360 * US


@pytest.mark.parametrize("metric, value", [
    ("entry.host_ms_to_launch", 0.11),          # calls 3 and 4: 150 and 70 us to the first enqueue's end
    ("backends.span_host_ms_per_call", 0.285),  # 900 - 480 and 500 - 350 us
    ("kernels.enqueue_us_per_launch", 40.0),    # 50, 40 and 20 us
    ("device.port_idle_ms_per_call", 0.18),     # 360 us inside calls over 2 traced calls
])
def test_readings(metric, value):
    record = {"spans": bench_spans.reduce(SPANS, [(SEGMENT, True)])}
    read, unit = bench_spans.READERS[metric]
    assert read(record) == pytest.approx(value) and unit in ("ms", "us")


def test_the_record_and_its_idle_table():
    rec = bench_spans.reduce(SPANS, [(SEGMENT, True)])
    assert rec["calls"] == 2 and rec["passes_per_call"] == 1.5 and rec["spans_per_call"] == 5
    seg = rec["segment"]
    assert seg["idle_ns"] == 400 * US and seg["calls"] == 2
    assert seg["idle_by_span"][0] == ("entry.sync", 255 * US)
    assert [t for _, t in seg["idle_by_span"]] == sorted((t for _, t in seg["idle_by_span"]), reverse=True)
    assert seg["span_stats"]["entry.call"][0] == 2


def test_no_complete_segment_reads_no_idle():
    rec = bench_spans.reduce(SPANS, [(SEGMENT, False)])
    assert rec["segment"] is None
    assert bench_spans.READERS["device.port_idle_ms_per_call"][0]({"spans": rec}) is None
    # the calls inside the incomplete segment's window still count as covered
    assert rec["calls"] == 2


def _event(name, start_us, end_us, device):
    kind = torch.autograd.DeviceType.CUDA if device else torch.autograd.DeviceType.CPU
    return SimpleNamespace(name=name, device_type=kind, time_range=SimpleNamespace(start=start_us, end=end_us),
                           is_user_annotation=False)


def test_a_segment_is_read_as_the_trace_reads_it():
    """Window and busy time as ``benchmark.trace.reduce`` counts them: a
    device interval counts when it starts inside a traced call, clipped to
    the window."""
    events = [_event(bench_trace.CALL_SPAN, 10.0, 400.0, False), _event(bench_trace.CALL_SPAN, 450.0, 900.5, False),
              _event("aten::empty", 20.0, 30.0, False),
              _event("ss::tile_pass_kernel", 50.0, 300.0, True), _event("ss::tile_pass_kernel", 290.0, 420.25, True),
              _event("Memcpy DtoD", 420.5, 460.0, True), _event("ss::tile_pass_kernel", 500.0, 950.0, True)]
    prof = SimpleNamespace(events=lambda: events,
                           profiler=SimpleNamespace(kineto_results=SimpleNamespace(trace_start_ns=lambda: 10**18)))
    seg = bench_spans.profile_segment(prof)
    assert seg["window"] == (10**18 + 10 * US, 10**18 + 900 * US + 500) and seg["calls"] == 2
    assert seg["busy"] == [(10**18 + 50 * US, 10**18 + 420 * US + 250), (10**18 + 500 * US, 10**18 + 900 * US + 500)]
    trace = bench_trace.reduce(prof, {}, {})
    busy_ns = sum(e - s for s, e in seg["busy"])
    assert busy_ns == pytest.approx(trace["busy_us"] * US)
    assert seg["window"][1] - seg["window"][0] == pytest.approx(trace["window_us"] * US)


def test_a_traced_run_on_the_cpu_holds_spans(test_root):
    """The runner's record holds the window's calls outside the profiled
    segment; on the CPU there is no enqueue and no device, so only the host
    reading is read. Afterwards spans are off and the trace's reduce is the
    benchmark's own again."""
    from stencilstream_tpu_torch import tracing

    reduce_before = bench_trace.reduce
    result, record = bench_spans.run_with_spans(Spec(test_root), "test-jac", 2**31 + 77, 0.5, device="cpu")
    rec = record["spans"]
    assert rec["calls"] >= 1 and len(rec["outside_sync_ms"]) == rec["calls"]
    assert rec["passes_per_call"] == 1 and rec["to_launch_ms"] == [] and rec["enqueue_us"] == []
    assert result["correct"] is True
    assert result["metrics"]["backends.span_host_ms_per_call"]["value"] > 0
    assert "entry.host_ms_to_launch" not in result["metrics"] and "idle_by_span" not in result["breakdown"]
    assert bench_trace.reduce is reduce_before and not tracing.on and tracing.collect() == []
