"""Host time of a call outside the port's waits for the device, in ms: the
median, over the span segment's unprofiled calls with the port's spans on
(``benchmark.span_segment``), of the benchmark call's time less every
``entry.sync`` and ``models.readback`` span inside it (a convection call
holds 16 blocking updates and 8 readbacks, so its last synchronize alone
leaves most of them in). None without a launch on a card (on the CPU the
plain versions' work is host time too)."""

from benchmark.span_segment import median, read as segment


def read(record):
    seg = segment(record, __file__)
    return median(seg["free"]["host_ms"]) if seg and seg["free"]["enqueue_us"] else None
