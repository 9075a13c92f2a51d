"""Host time of a traced call outside its final synchronize, in ms: the
benchmark's span around the call less the last synchronize inside it, from
the profiler's host events, averaged over the traced calls."""


def read(record):
    trace = record["trace"]
    if trace is None or not trace["host_us_outside_sync"]:
        return None
    return sum(trace["host_us_outside_sync"]) / len(trace["host_us_outside_sync"]) / 1e3
