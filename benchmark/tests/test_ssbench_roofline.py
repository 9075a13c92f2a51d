"""The roofline counts the work from the configuration, not the geometry
that ran, and the kernel time rests on launches the profiler saw."""

from types import SimpleNamespace

import pytest
import torch

from benchmark import trace as tracing
from benchmark.roofline import bound_s, peak_for
from benchmark.spec import Spec

H100 = "NVIDIA H100 80GB HBM3"


def _traffic(side, n):
    return {"height": side, "width": side, "n_iterations": n, "backend": "auto", "options": {}}


def test_peaks_are_the_data_sheet():
    peak = peak_for(Spec().peaks(), H100)
    assert peak["float32_flop_per_s"] == 67e12
    assert peak["hbm_bytes_per_s"] == 3.35e12
    assert peak_for(Spec().peaks(), "cpu") is None


@pytest.mark.parametrize("config,side,n,ms,by", [
    ("hotspot", 8192, 200, 2.0031, "operations"),  # 1.342e11 operations at 67 TFLOP/s
    ("hotspot", 1024, 1000, 0.15650, "operations"),
    ("jacobi5", 8192, 200, 1.8028, "operations"),
    ("hotspot", 8192, 1, 0.24037, "bytes"),  # 12 B a cell once a call at 3.35 TB/s
    ("jacobi5", 8192, 1, 0.16025, "bytes"),
])
def test_bound(config, side, n, ms, by):
    spec = Spec()
    seconds, what = bound_s(spec.config(config), _traffic(side, n), peak_for(spec.peaks(), H100))
    assert seconds * 1e3 == pytest.approx(ms, rel=1e-4)
    assert what == by


def test_bound_ignores_backend_options():
    spec = Spec()
    peak = peak_for(spec.peaks(), H100)
    base = bound_s(spec.config("jacobi5"), _traffic(8192, 200), peak)
    other = dict(_traffic(8192, 200), backend="tiling", options={"window_mode": "linecache", "iters_per_pass": 4})
    assert bound_s(spec.config("jacobi5"), other, peak) == base


def _trace(seen, counted, calls=4):
    return {"calls": calls, "launches": counted,
            "kernels": {f"void ss::{k}_kernel<ss::HotspotOp>(...)": {"us": us, "seen": n}
                        for k, (us, n) in seen.items()}}


def test_kernel_time_scales_seen_to_counted():
    # 90 launches counted, 60 seen at 900 us each: 81 ms over 4 calls
    t = _trace({"tile_pass": (60 * 900.0, 60)}, {"tile_pass": 90, "monotile": 0})
    assert tracing.kernel_ms_per_call(t) == pytest.approx(90 * 0.9 / 4)


def _profile(device_events, spans=((0.0, 100.0),)):
    """A finished profile's events: the benchmark's call spans on the host,
    and device operations ``(start, end, name)``."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def event(kind, s, e, name):
        return SimpleNamespace(device_type=kind, name=name, device_index=0, time_range=SimpleNamespace(start=s, end=e))

    events = [event(cpu, s, e, tracing.CALL_SPAN) for s, e in spans]
    events += [event(cuda, s, e, name) for s, e, name in device_events]
    return SimpleNamespace(events=lambda: events)


def test_kernel_time_refuses_a_kernel_never_seen():
    """A segment in which the profiler saw fewer launches of a module's
    kernel than the module counted is not complete."""
    kernels = [(10.0, 30.0, "void ss::tile_pass_kernel<ss::HotspotOp>(...)"),
               (40.0, 60.0, "void ss::tile_pass_kernel<ss::HotspotOp>(...)")]
    before = {"tile_pass": 5, "line_cache": 0}
    seen_all = tracing.reduce(_profile(kernels), before, {"tile_pass": 7, "line_cache": 0})
    assert seen_all["complete"] and seen_all["busy_us"] == 40.0 and seen_all["window_us"] == 100.0
    one_missed = tracing.reduce(_profile(kernels), before, {"tile_pass": 8, "line_cache": 0})
    assert not one_missed["complete"] and one_missed["launches_seen"]["tile_pass"] == 2
    never_seen = tracing.reduce(_profile(kernels), before, {"tile_pass": 7, "line_cache": 1})
    assert not never_seen["complete"]


def test_roofline_reader_reports_nothing_without_kernels():
    read = Spec().reader("kernels_roofline")
    record = {"bound_s": 2e-3, "trace": _trace({}, {"tile_pass": 0})}
    assert read(record) is None
    record["trace"] = _trace({"tile_pass": (25 * 800.0, 25)}, {"tile_pass": 25}, calls=1)
    assert read(record) == pytest.approx(2.0 / 20.0 * 100)


def test_union_and_gaps():
    assert tracing._union([(5, 7), (0, 2), (1, 3), (7, 8)]) == [[0, 3], [5, 8]]
