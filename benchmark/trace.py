"""The traced run: ``torch.profiler`` over the first calls of the window,
reduced to what the per-layer readers read.

The benchmark wraps each traced call in a ``record_function`` span
(:data:`CALL_SPAN`). From the profiler's events it keeps:

* the traced window: the first span's start to the last span's end;
* each card's busy time: the union of the card's device intervals
  (kernels, copies, fills; grouped by ``device_index``) that start inside a
  span (the benchmark's own copies between calls do not count), and their
  mean over the cards; the idle gaps of the window on the idlest card, each
  named by the innermost host event under way at its middle and the host
  events just before and after it;
* the device time and the launches seen of every kernel, by name, summed
  over the cards;
* a span's host time outside its final synchronize.

The launch counters of the port's kernel modules (``<module>.launches``)
are read before and after. The profiler can miss launches: a segment in
which it saw fewer launches of a module's kernel than the module counted is
marked not ``complete``, and the run throws it away (busy time, idle gaps and
kernel times alike). A kernel's time a call is its time per launch seen
times the launches counted (:func:`kernel_ms_per_call`).
"""

from __future__ import annotations

import bisect
import sys
from collections import defaultdict

import torch

__all__ = ["CALL_SPAN", "launch_counters", "reduce", "kernel_ms_per_call"]

CALL_SPAN = "ssbench.call"
#: Host events that wait for the device.
SYNC_NAMES = ("cudaDeviceSynchronize", "cudaStreamSynchronize")
PORT = "stencilstream_tpu_torch"


def launch_counters() -> dict[str, int]:
    """Every loaded module of the port with an integer ``launches``: the
    kernel launches it has made, by the module's last name (``tile_pass``,
    ``line_cache``, ``monotile``). Its kernel is ``ss::<name>_kernel``."""
    out = {}
    for name, module in list(sys.modules.items()):
        if name.split(".")[0] == PORT and isinstance(getattr(module, "launches", None), int):
            out[name.rsplit(".", 1)[-1]] = module.launches
    return out


def _union(intervals):
    """Merged, sorted ``(start, end)`` intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce(prof, counters_before: dict, counters_after: dict, cards=None) -> dict:
    """What the readers need from a finished profile (times in µs).
    ``cards`` are the device indices the run uses; a card that ran nothing
    in the window is idle in it. With one card, or none given, every device
    interval is that card's."""
    events = prof.events()
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == cpu and e.name == CALL_SPAN)
    if not spans:
        raise RuntimeError(f"the profile holds no {CALL_SPAN!r} span")
    t0, t1 = spans[0][0], spans[-1][1]
    # A span also shows on the device's timeline (a user annotation): only
    # the device's own operations count as busy.
    device = [(e.time_range.start, e.time_range.end, e.name, e.device_index) for e in events
              if e.device_type == cuda and e.time_range.end > e.time_range.start
              and not getattr(e, "is_user_annotation", False) and e.name != CALL_SPAN]
    starts = [s for s, _ in spans]

    def in_span(t):
        k = bisect.bisect_right(starts, t) - 1
        return k >= 0 and t <= spans[k][1]

    device = [d for d in device if in_span(d[0])]
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type == cpu and e.time_range.end > e.time_range.start]

    cards = list(cards) if cards is not None and len(cards) > 1 else [None]

    def on(card, c):
        return c is None or card == c

    busy = {c: _union((max(s, t0), min(e, t1)) for s, e, _, card in device if on(card, c) and e > t0 and s < t1)
            for c in cards}
    busy_by_card = {c: sum(e - s for s, e in busy[c]) for c in cards}
    idlest = min(cards, key=lambda c: busy_by_card[c])

    by_name = defaultdict(lambda: [0.0, 0])
    for s, e, name, _ in device:
        if e > t0 and s < t1:
            by_name[name][0] += e - s
            by_name[name][1] += 1

    def under_way(t):
        """What the host was doing at ``t``: the innermost host event that
        covers it, and the host events that ended last before it and
        started first after it."""
        covering = [(e - s, name) for s, e, name in host if s <= t <= e]
        before = max(((e, name) for s, e, name in host if e < t), default=(0, "start"))[1]
        after = min(((s, name) for s, e, name in host if s > t), default=(0, "end"))[1]
        inner = min(covering)[1] if covering else "between calls"
        return f"{inner}: {before} -> {after}"

    edges = [t0] + [x for iv in busy[idlest] for x in iv] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2) if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    idle_gaps = [[under_way((s + e) / 2), (e - s) / 1e6] for s, e in gaps[:10]]

    all_syncs = [(s, e) for s, e, name in host if name in SYNC_NAMES]
    host_us = []
    for s, e in spans:
        syncs = [(ss, se) for ss, se in all_syncs if s <= ss and se <= e]
        if syncs:
            last = max(syncs)
            host_us.append((e - s) - (last[1] - last[0]))

    launches = {k: counters_after.get(k, 0) - counters_before.get(k, 0) for k in counters_after}
    launches_seen = {k: sum(v[1] for name, v in by_name.items() if f"{k}_kernel" in name) for k in counters_after}
    return {
        "complete": all(launches_seen[k] >= n for k, n in launches.items()),
        "calls": len(spans),
        "window_us": t1 - t0,
        "busy_us": sum(busy_by_card.values()) / len(cards),
        "busy_us_by_card": busy_by_card,
        "kernels": {name: {"us": v[0], "seen": v[1]} for name, v in by_name.items()},
        "device_ops": sorted(([name, v[0] / 1e6] for name, v in by_name.items()), key=lambda x: -x[1])[:10],
        "idle_gaps": idle_gaps,
        "host_us_outside_sync": host_us if len(host_us) == len(spans) else None,
        "launches": launches,
        "launches_seen": launches_seen,
    }


def kernel_ms_per_call(trace: dict, chips: int = 1) -> float:
    """Device time of the port's kernels a traced call and card: for each
    kernel module, its kernels' device time per launch the profiler saw,
    times the launches its counter counted (on every card), over the traced
    calls and the cell's ``chips``. Read only from a ``complete`` segment,
    where every counted module was seen."""
    total_us = 0.0
    for module, counted in trace["launches"].items():
        if counted <= 0:
            continue
        seen = [v for name, v in trace["kernels"].items() if f"{module}_kernel" in name]
        total_us += sum(v["us"] for v in seen) / sum(v["seen"] for v in seen) * counted
    return total_us / trace["calls"] / 1e3 / chips
