"""Share of the traced window in which nothing ran on the device, in %: one
less the union of the profiler's device intervals over the window from the
first traced call's start to the last one's end."""


def read(record):
    trace = record["trace"]
    if trace is None or not trace["busy_us"]:
        return None
    return (1.0 - trace["busy_us"] / trace["window_us"]) * 100.0
