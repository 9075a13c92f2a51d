"""Device idle time a call while the host plans, in ms: in the span
segment's profiled calls (``benchmark.span_segment``), the time a card ran
nothing while ``backends.plan`` or ``backends.choose`` was the innermost
port span, the mean over the cell's cards, over the calls. Those calls run
under the profiler, so the reading is higher than an untraced call's would
be. None without device operations, as on the CPU."""

from benchmark.span_segment import read as segment

SPANS = ("backends.plan", "backends.choose")


def read(record):
    seg = segment(record, __file__)
    prof = seg and seg["profiled"]
    if not prof or not prof["device"]:
        return None
    return sum(prof["idle_by_span"].get(name, 0) for name in SPANS) / prof["calls"] / 1e6
