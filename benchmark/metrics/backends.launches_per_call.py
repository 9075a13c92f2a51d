"""Kernel launches a traced call: the deltas of the port's kernel modules'
``launches`` counters over the traced calls, over the calls."""


def read(record):
    trace = record["trace"]
    if trace is None:
        return None
    return sum(trace["launches"].values()) / trace["calls"]
