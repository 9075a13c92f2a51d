"""The whole call's share of the card's peak, in %: the least time a call's
work needs (the same bound as ``kernels_roofline``) times the traced calls,
over the traced window on the profiler's host clock. It bounds the kernels'
share: work moved out of the port's kernels still counts against it."""


def read(record):
    trace = record["trace"]
    if trace is None or record["bound_s"] is None:
        return None
    return record["bound_s"] * trace["calls"] / (trace["window_us"] / 1e6) * 100.0
