"""Device time a traced call and card of the halo exchange's copies between
cards, in us: the profiler's ``Memcpy PtoP`` operations inside the calls,
summed over the cell's cards, over the traced calls and the cards. None
without any, as on one card or on the CPU."""


def read(record):
    trace = record["trace"]
    if trace is None:
        return None
    us = sum(v["us"] for name, v in trace["kernels"].items() if name.startswith("Memcpy PtoP"))
    if not us:
        return None
    return us / trace["calls"] / record.get("chips", 1)
