"""The 95th percentile of the window's call times, in ms: CUDA events
recorded on the stream before and after each call (device timestamps; the
host clock is too coarse for calls of a few ms). On the CPU, the host clock."""

import statistics


def read(record):
    return statistics.quantiles(record["call_ms"], n=20)[18]
