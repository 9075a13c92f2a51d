"""Host time from a call's start to the end of its first kernel launch, in
ms: the median, over the span segment's unprofiled calls with the port's
spans on (``benchmark.span_segment``), of the benchmark call's start to the
end of its first ``kernels.enqueue`` span. In a loop of blocking calls the
device waits this long at every call's start. None without an enqueue, as
on the CPU."""

from benchmark.span_segment import median, read as segment


def read(record):
    seg = segment(record, __file__)
    return median(seg["free"]["to_launch_ms"]) if seg else None
