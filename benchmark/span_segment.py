"""The traced run's second segment: the port's own spans
(``stencilstream_tpu_torch.tracing``) over calls of the cell, read by the
span and counter metrics.

``benchmark.run`` reads its per-layer metrics once the window has closed
and its grids are freed. The first of these readers to call :func:`read`
makes the segment, once a record:

1. it builds the cell's updater again through the app of the checkout the
   metric lies in (``make_update``) and its inputs from :data:`SEED` (the
   readings are host and idle times, which the cell's values do not move;
   a reader is handed no seed), block by block on the cards of a cell in
   blocks, and warms up with :data:`WARMUP_CALLS` calls, spans off;
2. it turns spans on, starts the profiler, runs :data:`STARTUP_SECONDS` of
   calls that are not counted (the profiler can miss the launches just
   after its start), then profiles up to :data:`SEGMENT_SECONDS` of calls,
   each wrapped in the benchmark's call span as the first segment's are,
   and reduces the profile with ``benchmark.trace.reduce``, whose
   completeness check against the launch counters throws away a segment in
   which the profiler missed a launch (:data:`SEGMENTS` tries);
3. it runs as long again with spans on and no profiler, and turns spans
   off, collects them and frees the updater and its grids.

Every call is timed on the spans' clock (``tracing.clock``), and each span
belongs to the call it falls in: a convection call, one timestep, holds 17
``entry.call`` spans and the ``models.*`` spans between them. Both stretches
are at most a third of the run's window, so a short run (the CPU tests)
makes a short segment. The first segment, from which every other reader
reads, is the window's, made with spans off.

The profiled calls give, for each card, the device's idle time under the
innermost port span open at that moment, or :data:`OUTSIDE`, as
``device.idle_share`` counts idle time (the window from the first profiled
call's start to the last one's end; the device busy where an interval that
started inside a profiled call runs), and its mean over the cards. They
also check the spans' clock against the profiler's: each host launch event
(:data:`LAUNCH_EVENTS`) should lie inside the
``kernels.enqueue`` span of its launch; where one lies more than
:data:`CLOCK_SLACK_NS` outside it, the spans are moved by the median offset
of span and event over all pairs (``span_clock``). The unprofiled calls give
the host-clock readings, free of the profiler's cost.

The segment runs under the profiler, so its idle readings are higher than
an untraced call's would be. What ``benchmark.run`` cannot carry in its
result line (it builds ``breakdown`` itself), the idle table and the clock
check, goes to standard error. A segment that fails, or that never
completes, reads nothing: the run goes on without these metrics.
"""

from __future__ import annotations

import bisect
import gc
import json
import statistics
import sys
import traceback
from pathlib import Path

import torch

from . import trace as bench_trace
from .layout import Layout, mesh_of
from .spec import Spec

__all__ = ["OUTSIDE", "innermost", "idle_by_span", "reduce_free", "reduce_profiled", "read", "median"]

#: Seconds the profiled stretch, and the unprofiled one after it, run at most.
SEGMENT_SECONDS = 3.0
#: Profiled stretches tried before the segment gives up on a complete one
#: (on an H100 about one stretch in six missed a launch or more).
SEGMENTS = 5
#: Seconds of calls, one at least and at most a stretch's, the profiler runs
#: before the counted ones: it can miss launches just after its start.
STARTUP_SECONDS = 0.25
WARMUP_CALLS = 2
#: The seed the segment's inputs are drawn from.
SEED = 2**31 + 26
OUTSIDE = "outside the port"
ENQUEUE = "kernels.enqueue"
#: The port's waits for the device inside a call.
WAITS = ("entry.sync", "models.readback")
#: Host events of a kernel launch, as the profiler names them (and their
#: ``Ex`` forms); the resident grid's is cooperative.
LAUNCH_EVENTS = ("cudaLaunchKernel", "cudaLaunchCooperativeKernel", "cuLaunchKernel", "cuLaunchCooperativeKernel")
#: The most a launch event may lie outside its span before the spans move.
CLOCK_SLACK_NS = 5_000
#: Rows of the idle table on standard error.
IDLE_ROWS = 10
#: Counters of the port logged a call, by module: ``launches`` and what the
#: tile pass's laws engaged, the exchange's copies, the solver's iterations.
COUNTERS = {
    "tile_pass": ("launches", "vector_launches", "inplace_launches", "reach_launches"),
    "line_cache": ("launches",), "monotile": ("launches",),
    "distributed": ("exchanges", "exchange_bytes"), "convection": ("pt_iterations",),
}


def log(*parts) -> None:
    print("ssbench:", *parts, file=sys.stderr, flush=True)


def median(values):
    return statistics.median(values) if values else None


def innermost(spans, t0: int, t1: int) -> list[tuple[int, int, str]]:
    """``[t0, t1]`` cut into stretches, each named by the innermost of the
    ``(name, start, end)`` spans open over it (:data:`OUTSIDE` where none
    is). Spans nest, as one thread opens them."""
    out, stack, cur = [], [], t0

    def until(t, name):
        nonlocal cur
        if min(t, t1) > cur:
            out.append((cur, min(t, t1), name))
            cur = min(t, t1)

    for name, s, e in sorted(spans, key=lambda x: (x[1], -x[2])):
        while stack and stack[-1][0] <= s:
            until(*stack.pop())
        until(s, stack[-1][1] if stack else OUTSIDE)
        stack.append((e, name))
    while stack:
        until(*stack.pop())
    until(t1, OUTSIDE)
    return out


def idle_by_span(stretches, busy, t0: int, t1: int) -> dict[str, int]:
    """The time of ``[t0, t1]`` outside the sorted, merged ``busy``
    intervals, by the name of the :func:`innermost` stretch it falls in."""
    idle, cur = [], t0
    for s, e in busy:
        if s > cur:
            idle.append((cur, min(s, t1)))
        cur = max(cur, e)
    if t1 > cur:
        idle.append((cur, t1))
    out, k = {}, 0
    for a, b, name in stretches:
        while k < len(idle) and idle[k][1] <= a:
            k += 1
        j = k
        while j < len(idle) and idle[j][0] < b:
            overlap = min(b, idle[j][1]) - max(a, idle[j][0])
            if overlap > 0:
                out[name] = out.get(name, 0) + overlap
            j += 1
    return out


def reduce_free(calls, spans) -> dict:
    """The host-clock readings of the unprofiled calls ``(start, end)`` and
    the ``(name, start, end)`` spans recorded over them (one clock): a
    call's start to the end of its first ``kernels.enqueue``, its time less
    every wait for the device inside it (:data:`WAITS`), in ms, and each
    enqueue, in us."""
    spans = sorted(spans, key=lambda x: x[1])
    starts = [s for _, s, _ in spans]
    to_launch, host, enqueue = [], [], []
    for s, e in calls:
        mine = [x for x in spans[bisect.bisect_left(starts, s):bisect.bisect_right(starts, e)] if x[2] <= e]
        ends = [x[2] for x in mine if x[0] == ENQUEUE]
        if ends:
            to_launch.append((min(ends) - s) / 1e6)
        waits = bench_trace._union((a, b) for name, a, b in mine if name in WAITS)
        host.append((e - s - sum(b - a for a, b in waits)) / 1e6)
        enqueue.extend((b - a) / 1e3 for name, a, b in mine if name == ENQUEUE)
    return {"calls": len(calls), "to_launch_ms": to_launch, "host_ms": host, "enqueue_us": enqueue}


def _clock(spans, launches) -> dict:
    """Each ``kernels.enqueue`` span against the launch event nearest it:
    the share of spans that hold one, the largest move a span would need to
    hold its event (ns, signed), and the median offset of event and span
    midpoints."""
    enqueues = [(s, e) for name, s, e in spans if name == ENQUEUE]
    if not enqueues or not launches:
        return {"pairs": 0, "held": None, "worst_ns": None, "median_ns": None}
    mids = sorted(((s + e) / 2, s, e) for s, e in launches)
    keys = [m for m, _, _ in mids]
    held, worst, offsets = 0, 0, []
    for s, e in enqueues:
        k = bisect.bisect_left(keys, (s + e) / 2)
        _, ls, le = min(mids[max(k - 1, 0):k + 1], key=lambda m: abs(m[0] - (s + e) / 2))
        need = ls - s if ls < s else max(le - e, 0)
        held += need == 0
        worst = need if abs(need) > abs(worst) else worst
        offsets.append((ls + le - s - e) / 2)
    return {"pairs": len(enqueues), "held": held / len(enqueues), "worst_ns": worst,
            "median_ns": statistics.median(offsets)}


def reduce_profiled(window, busy: dict, spans, launches, calls: int, counters: dict) -> dict:
    """The profiled calls: ``window`` ``(t0, t1)``, each card's sorted,
    merged ``busy`` intervals, the ``(name, start, end)`` spans and the host
    launch events ``(start, end)``, all on the profiler's clock. The spans
    are moved by the median offset of the clock check where a launch event
    lies more than :data:`CLOCK_SLACK_NS` outside its span. The idle time
    by innermost span is the mean over the cards."""
    t0, t1 = window
    clock = _clock(spans, launches)
    shift = 0
    if clock["worst_ns"] is not None and abs(clock["worst_ns"]) > CLOCK_SLACK_NS:
        shift = round(clock["median_ns"])
        spans = [(name, s + shift, e + shift) for name, s, e in spans]
        clock["after"] = _clock(spans, launches)
    clock["shift_ns"] = shift
    stretches = innermost([x for x in spans if x[2] > t0 and x[1] < t1], t0, t1)
    by_name = {}
    for card_busy in busy.values():
        for name, t in idle_by_span(stretches, card_busy, t0, t1).items():
            by_name[name] = by_name.get(name, 0) + t / len(busy)
    names = {}
    for name, s, e in spans:
        if e > t0 and s < t1:
            names[name] = names.get(name, 0) + 1
    idle = sum(t1 - t0 - sum(e - s for s, e in card_busy) for card_busy in busy.values()) / len(busy)
    return {"calls": calls, "window_ns": t1 - t0, "device": any(busy.values()), "idle_ns": idle,
            "idle_by_span": dict(sorted(by_name.items(), key=lambda kv: -kv[1])), "spans": names,
            "span_clock": clock, "counters": counters}


def read(record: dict, reader: str) -> dict | None:
    """The segment's readings, ``{"free": reduce_free(...), "profiled":
    reduce_profiled(...) or None}``, made once and kept in the record
    (``record["span_segment"]``); None where no segment could be made. The
    cell's app is the one of the checkout that holds ``reader``, the file of
    the metric that reads."""
    if "span_segment" not in record:
        try:
            record["span_segment"] = _measure(record, Path(reader).resolve().parents[2])
        except Exception:  # the run must go on: these metrics then read nothing
            log("the span segment failed:\n" + traceback.format_exc())
            record["span_segment"] = None
    return record["span_segment"]


def _counters() -> dict:
    """The :data:`COUNTERS` of the loaded port modules, by ``<module>.<counter>``."""
    out = {}
    for name, module in list(sys.modules.items()):
        last = name.rsplit(".", 1)[-1]
        if name.split(".")[0] == bench_trace.PORT and last in COUNTERS:
            out.update({f"{last}.{attr}": getattr(module, attr) for attr in COUNTERS[last]
                        if isinstance(getattr(module, attr, None), int)})
    return out


def _build(record: dict, root: Path):
    """The cell's updater, its grid from :data:`SEED` and its cards."""
    config, traffic = record["config"], record["traffic"]
    app = Spec(root).app(config["name"])
    H, W = traffic["height"], traffic["width"]
    on_card = bool(record["peak_bytes"])
    ny, nx = mesh_of(traffic, record["chips"])
    if ny * nx == 1:
        dev = torch.device("cuda" if on_card else "cpu")
        grid, cards = app.to_grid(app.make_inputs(H, W, SEED, dev)), [dev]
    else:
        devices = [torch.device("cuda", k) if on_card else torch.device("cpu") for k in range(ny * nx)]
        layout = Layout(H, W, (ny, nx), devices)
        grid = app.to_grid({key: app.make_block_inputs(H, W, SEED, rows, cols, device)
                            for key, (rows, cols, device) in layout.blocks.items()})
        cards = layout.devices()
    return app.make_update(config, traffic), grid, cards, on_card


def _measure(record: dict, root: Path) -> dict | None:
    from stencilstream_tpu_torch import tracing

    if tracing.on:
        log("spans are on already (another recorder holds them): the span segment is not made")
        return None
    seconds = min(SEGMENT_SECONDS, record["window_s"] / 3)
    calls_per_run = record["traffic"].get("calls_per_run", 0)
    update, grid, cards, on_card = _build(record, root)
    initial, done = grid, 0

    def calls(seconds, profiled):
        nonlocal grid, done
        times, t_end = [], tracing.clock() + seconds * 1e9
        while not times or times[-1][1] < t_end:
            if calls_per_run and done and done % calls_per_run == 0:
                grid = initial
            s = tracing.clock()
            if profiled:
                with torch.profiler.record_function(bench_trace.CALL_SPAN):
                    grid = update(grid)
            else:
                grid = update(grid)
            times.append((s, tracing.clock()))
            done += 1
        return times

    activities = [torch.profiler.ProfilerActivity.CPU] + ([torch.profiler.ProfilerActivity.CUDA] if on_card else [])
    trace = None
    try:
        for _ in range(WARMUP_CALLS):
            grid = update(grid)
        tracing.collect()
        tracing.enable()
        for attempt in range(1, SEGMENTS + 1):
            tracing.collect()
            prof = torch.profiler.profile(activities=activities)
            prof.start()
            try:
                calls(min(STARTUP_SECONDS, seconds), False)
                tracing.collect()
                before, counters_before = bench_trace.launch_counters(), _counters()
                calls(seconds, True)
            finally:
                prof.stop()
            after, counters_after = bench_trace.launch_counters(), _counters()
            trace = bench_trace.reduce(prof, before, after, [d.index for d in cards])
            if trace["complete"]:
                break
            log(f"the profiler missed launches in span segment {attempt} (counted / seen):",
                json.dumps({k: [v, trace["launches_seen"][k]] for k, v in trace["launches"].items() if v}))
            trace = None
        profiled_spans = tracing.collect()
        free = calls(seconds, False)
    finally:
        tracing.disable()
        free_spans = tracing.collect()
        del update, grid, initial
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    out = {"free": reduce_free(free, [(s.name, s.start_ns, s.end_ns) for s in free_spans]), "profiled": None}
    log(f"span segment: {len(free)} unprofiled calls with spans on")
    if trace is None:
        log("span segment: no complete profiled stretch; its idle readings read nothing")
        return out
    out["profiled"] = _reduce_profile(prof, profiled_spans, cards, trace["calls"], {
        k: v - counters_before.get(k, 0) for k, v in counters_after.items()})
    _log_profiled(out["profiled"])
    return out


def _reduce_profile(prof, spans, cards, calls: int, counters: dict) -> dict:
    """:func:`reduce_profiled` of a finished profile, in Unix ns: the
    profiler's host timeline is ``trace_start_ns`` plus an event's offset,
    the spans' is ``tracing.to_unix_ns``."""
    from stencilstream_tpu_torch import tracing

    origin = prof.profiler.kineto_results.trace_start_ns()
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ns(e):
        return origin + round(e.time_range.start * 1e3), origin + round(e.time_range.end * 1e3)

    events = prof.events()
    windows = sorted(ns(e) for e in events if e.device_type == cpu and e.name == bench_trace.CALL_SPAN)
    starts = [s for s, _ in windows]

    def in_call(t):
        k = bisect.bisect_right(starts, t) - 1
        return k >= 0 and t <= windows[k][1]

    t0, t1 = windows[0][0], windows[-1][1]
    indices = [d.index for d in cards] if len(cards) > 1 else [None]
    busy = {c: [] for c in indices}
    for e in events:
        if (e.device_type == cuda and e.time_range.end > e.time_range.start
                and not getattr(e, "is_user_annotation", False) and e.name != bench_trace.CALL_SPAN):
            s, end = ns(e)
            card = None if indices == [None] else e.device_index
            if in_call(s) and card in busy and end > t0 and s < t1:
                busy[card].append((max(s, t0), min(end, t1)))
    busy = {c: [tuple(iv) for iv in bench_trace._union(ivs)] for c, ivs in busy.items()}
    launches = [ns(e) for e in events if e.device_type == cpu and e.name.startswith(LAUNCH_EVENTS)]
    unix = [(s.name, tracing.to_unix_ns(s.start_ns), tracing.to_unix_ns(s.end_ns)) for s in spans]
    return reduce_profiled((t0, t1), busy, unix, launches, calls, counters)


def _log_profiled(seg: dict) -> None:
    clock = seg["span_clock"]
    log(f"span segment: {seg['calls']} profiled calls, {seg['idle_ns'] / 1e6:.4f} ms idle a card of "
        f"{seg['window_ns'] / 1e6:.4f} ms, {sum(seg['idle_by_span'].values()) / 1e6:.4f} of it by span; "
        f"span_clock {json.dumps(clock)}")
    if clock["shift_ns"]:
        log(f"span segment: a launch event lay {clock['worst_ns']} ns outside its enqueue span; the spans were "
            f"moved by {clock['shift_ns']} ns, after which {clock['after']['held']} of the launches are held")
    rows = list(seg["idle_by_span"].items())[:IDLE_ROWS]
    log("span segment: idle_by_span (s, mean over cards):", json.dumps([[n, t / 1e9] for n, t in rows]))
    per_call = {k: v / seg["calls"] for k, v in seg["counters"].items() if v}
    log("span segment: counters a profiled call:", json.dumps(per_call))
