"""Host time of one kernel launch's C launcher call, in us: the median
``kernels.enqueue`` span over the span segment's unprofiled calls with the
port's spans on (``benchmark.span_segment``). None without one, as on the
CPU."""

from benchmark.span_segment import median, read as segment


def read(record):
    seg = segment(record, __file__)
    return median(seg["free"]["enqueue_us"]) if seg else None
