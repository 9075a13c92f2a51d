"""The port's kernels' share of their roofline, in %: the least time a
call's work needs (``roofline.bound_s``, from the configuration's frozen
counts and the data-sheet peaks) over the device time of the port's kernels
a traced call (per launch the profiler saw, times the launches the counters
counted). None without kernel time, as on the CPU."""

from benchmark.trace import kernel_ms_per_call


def read(record):
    trace = record["trace"]
    if trace is None or record["bound_s"] is None:
        return None
    kernel_ms = kernel_ms_per_call(trace)
    if not kernel_ms:
        return None
    return record["bound_s"] * 1e3 / kernel_ms * 100.0
