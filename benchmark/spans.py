"""The port's spans in a traced run: four per-layer readings, and the
device's idle time by the port's own layers.

    python3 -m benchmark.spans --workload <cell> --seed <n> --seconds <s>

makes one traced run of the cell, as ``python3 -m benchmark.run ... --trace
1`` does (:func:`benchmark.run.run_cell`), with the port's spans
(``stencilstream_tpu_torch.tracing``) on from the window's first call, and
prints its result line with the readings below added to ``metrics`` and the
idle table to ``breakdown["idle_by_span"]``; the table also goes to standard
error with each span's count and 95th percentile. ``benchmark/run.py`` does
not record spans: this runner turns them on through the updater it wraps
(``run_cell``'s ``wrap``) once the warm-up calls are done, and reads each
profiled segment where ``benchmark.trace.reduce`` reduces it.

Every time here is a Unix-epoch nanosecond, as an integer: the profiler's
host timeline (``trace_start_ns`` plus an event's offset) and the port's
spans through ``tracing.to_unix_ns``. The readings, ``read(record)`` of a
record that holds ``record["spans"]`` (:func:`reduce`):

* ``entry.host_ms_to_launch`` (ms): the median, over the window's calls that
  no profiled segment covered, of the time from a call's ``entry.call`` start
  to the end of its first ``kernels.enqueue``: the host work the device waits
  for at a call's start;
* ``backends.span_host_ms_per_call`` (ms): the median, over the same calls, of
  ``entry.call`` less its ``entry.sync``: the call's host time outside its
  final synchronize;
* ``kernels.enqueue_us_per_launch`` (us): the median ``kernels.enqueue`` of
  the same calls: the C launcher's host cost a launch;
* ``device.port_idle_ms_per_call`` (ms): in the complete profiled segment, the
  device's idle time while the host was inside an ``entry.call``, over the
  segment's calls.

The segment's idle time is that of ``device.idle_share``: its window runs
from the first traced call's start to the last one's end, and the device is
busy where an interval that started inside a traced call runs. ``idle_by_span``
names each stretch of it by the innermost port span under way, or ``outside
the port``.
"""

from __future__ import annotations

import argparse
import bisect
import json
import statistics
import sys
from collections import defaultdict

import torch

from . import run
from . import trace as bench_trace
from .spec import Spec

__all__ = ["READERS", "idle_by_span", "main", "profile_segment", "reduce", "run_with_spans"]

OUTSIDE = "outside the port"
CALL, ENQUEUE, SYNC = "entry.call", "kernels.enqueue", "entry.sync"
#: Entries of ``breakdown["idle_by_span"]`` at most.
IDLE_ROWS = 10


def _median(values):
    return statistics.median(values) if values else None


def _p95(values):
    return statistics.quantiles(values, n=20)[18] if len(values) > 1 else values[0]


def profile_segment(prof) -> dict:
    """A finished profile of a traced segment, in Unix ns: its ``window``
    (the first traced call's start to the last one's end), its ``calls``,
    and the merged intervals in which the device was ``busy``, as
    ``benchmark.trace.reduce`` counts them."""
    origin = prof.profiler.kineto_results.trace_start_ns()
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ns(e):
        return origin + round(e.time_range.start * 1e3), origin + round(e.time_range.end * 1e3)

    events = prof.events()
    calls = sorted(ns(e) for e in events if e.device_type == cpu and e.name == bench_trace.CALL_SPAN)
    device = [ns(e) for e in events
              if e.device_type == cuda and e.time_range.end > e.time_range.start
              and not getattr(e, "is_user_annotation", False) and e.name != bench_trace.CALL_SPAN]
    starts = [s for s, _ in calls]

    def in_call(t):
        k = bisect.bisect_right(starts, t) - 1
        return k >= 0 and t <= calls[k][1]

    t0, t1 = calls[0][0], calls[-1][1]
    busy = bench_trace._union((max(s, t0), min(e, t1)) for s, e in device if in_call(s) and e > t0 and s < t1)
    return {"window": (t0, t1), "calls": len(calls), "busy": [tuple(iv) for iv in busy]}


def idle_by_span(spans: list[dict], window: tuple[int, int], busy: list[tuple[int, int]]) -> tuple[dict, int]:
    """The idle time of ``window`` outside the sorted, merged ``busy``
    intervals, in ns by the innermost span under way (:data:`OUTSIDE` where
    none is), and the part of it inside an ``entry.call``. Spans nest, as
    one thread opens them."""
    t0, t1 = window
    idle, cur = [], t0
    for s, e in busy:
        if s > cur:
            idle.append((cur, s))
        cur = max(cur, e)
    if t1 > cur:
        idle.append((cur, t1))
    spans = [s for s in spans if s["end"] > s["start"]]
    points = sorted([(s["end"], 0, i) for i, s in enumerate(spans)] + [(s["start"], 1, i) for i, s in enumerate(spans)])
    by_name, in_calls = defaultdict(int), 0
    stack, calls_open, k = [], 0, 0

    def advance(t):
        nonlocal k, calls_open
        while k < len(points) and points[k][0] <= t:
            _, opens, i = points[k]
            if opens:
                stack.append(i)
            else:
                stack.remove(i)
            calls_open += (1 if opens else -1) * (spans[i]["name"] == CALL)
            k += 1

    for a, b in idle:
        cur = a
        advance(cur)
        while cur < b:
            end = min(b, points[k][0]) if k < len(points) else b
            by_name[spans[stack[-1]]["name"] if stack else OUTSIDE] += end - cur
            if calls_open:
                in_calls += end - cur
            cur = end
            advance(cur)
    return dict(by_name), in_calls


def reduce(spans: list[dict], segments: list[tuple[dict, bool]]) -> dict:
    """What the readers read from the window's port spans (dicts with
    ``name``, ``start``, ``end``, ``call``; Unix ns) and its profiled
    segments (:func:`profile_segment`, and whether the segment was
    complete)."""
    windows = [seg["window"] for seg, _ in segments]
    by_call = defaultdict(list)
    for s in spans:
        if s["call"] is not None:
            by_call[s["call"]].append(s)
    to_launch, outside_sync, enqueue, passes, counts = [], [], [], [], []
    for members in by_call.values():
        top = [s for s in members if s["name"] == CALL]
        if len(top) != 1 or any(a <= top[0]["start"] <= b for a, b in windows):
            continue
        top = top[0]
        launches = sorted(s["end"] for s in members if s["name"] == ENQUEUE)
        if launches:
            to_launch.append((launches[0] - top["start"]) / 1e6)
        sync = sum(s["end"] - s["start"] for s in members if s["name"] == SYNC)
        outside_sync.append((top["end"] - top["start"] - sync) / 1e6)
        enqueue.extend((s["end"] - s["start"]) / 1e3 for s in members if s["name"] == ENQUEUE)
        passes.append(sum(s["name"] == "kernels.launch" for s in members))
        counts.append(len(members))
    out = {"calls": len(outside_sync), "to_launch_ms": to_launch, "outside_sync_ms": outside_sync,
           "enqueue_us": enqueue, "passes_per_call": _median(passes), "spans_per_call": _median(counts),
           "segment": None}
    complete = [seg for seg, ok in segments if ok and seg["busy"]]
    if complete:
        seg = complete[-1]
        t0, t1 = seg["window"]
        inside = [s for s in spans if s["end"] > t0 and s["start"] < t1]
        by_name, in_calls = idle_by_span(inside, seg["window"], seg["busy"])
        durations = defaultdict(list)
        for s in inside:
            durations[s["name"]].append((s["end"] - s["start"]) / 1e6)
        out["segment"] = {
            "calls": seg["calls"], "idle_ns": sum(by_name.values()), "port_idle_ns": in_calls,
            "idle_by_span": sorted(by_name.items(), key=lambda kv: -kv[1]),
            "span_stats": {name: [len(v), _p95(v)] for name, v in durations.items()},
        }
    return out


def _host_ms_to_launch(record):
    return _median(record["spans"]["to_launch_ms"])


def _span_host_ms_per_call(record):
    return _median(record["spans"]["outside_sync_ms"])


def _enqueue_us_per_launch(record):
    return _median(record["spans"]["enqueue_us"])


def _port_idle_ms_per_call(record):
    seg = record["spans"]["segment"]
    return seg["port_idle_ns"] / 1e6 / seg["calls"] if seg else None


#: The readings by metric name: ``(read(record), unit)``.
READERS = {
    "entry.host_ms_to_launch": (_host_ms_to_launch, "ms"),
    "backends.span_host_ms_per_call": (_span_host_ms_per_call, "ms"),
    "kernels.enqueue_us_per_launch": (_enqueue_us_per_launch, "us"),
    "device.port_idle_ms_per_call": (_port_idle_ms_per_call, "ms"),
}


def run_with_spans(spec: Spec, cell: str, seed: int, seconds: float, *, device: str = "cuda") -> tuple[dict, dict]:
    """One traced run with the port's spans on for the window: its result,
    with the readings and ``idle_by_span`` added, and the record the
    readings read."""
    from stencilstream_tpu_torch import tracing

    segments = []
    reduce_segment = bench_trace.reduce

    def reduce_and_keep(prof, before, after):
        out = reduce_segment(prof, before, after)
        segments.append((profile_segment(prof), out["complete"]))
        return out

    def wrap(update, app):
        calls = 0

        def call(grid):
            nonlocal calls
            calls += 1
            if calls == run.WARMUP_CALLS + 1:
                tracing.enable()
            return update(grid)

        return call

    bench_trace.reduce = reduce_and_keep
    try:
        result = run.run_cell(spec, cell, seed, seconds, True, device=device, wrap=wrap)
    finally:
        bench_trace.reduce = reduce_segment
        tracing.disable()
    spans = [{"name": s.name, "start": tracing.to_unix_ns(s.start_ns), "end": tracing.to_unix_ns(s.end_ns),
              "call": s.call} for s in tracing.collect()]
    record = {"spans": reduce(spans, segments)}
    for name, (read, unit) in READERS.items():
        value = read(record)
        if value is None:
            run.log(f"metric {name} has nothing to read in this run")
        else:
            result["metrics"][name] = {"value": value, "unit": unit}
    rec = record["spans"]
    run.log(f"spans: {rec['calls']} calls outside the profiled segment, {rec['passes_per_call']} launches "
            f"and {rec['spans_per_call']} spans a call")
    seg = rec["segment"]
    if seg is not None:
        result["breakdown"]["idle_by_span"] = [[name, t / 1e9] for name, t in seg["idle_by_span"][:IDLE_ROWS]]
        run.log(f"device idle by port span, {seg['calls']} traced calls, {seg['idle_ns'] / 1e6:.4f} ms idle "
                "(span: idle ms, spans, p95 ms):")
        for name, t in seg["idle_by_span"]:
            count, p95 = seg["span_stats"].get(name, ["-", float("nan")])
            run.log(f"  {name}: {t / 1e6:.4f} ms, {count}, {p95:.4f}")
    return result, record


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m benchmark.spans", description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    args = parser.parse_args(argv)
    spec = Spec()
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.cell(args.workload)["chips"]:
        run.log("the cell needs a CUDA card for each of its chips")
        return 1
    result, _ = run_with_spans(spec, args.workload, args.seed, args.seconds)
    if run.forbidden_modules():
        run.log(f"modules of JAX or the JAX package are loaded: {', '.join(run.forbidden_modules())}")
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
