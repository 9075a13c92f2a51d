"""The pseudo-transient kernels' share of the call's roofline, in %: the
least time a call's work needs (``roofline.bound_s``, from the
configuration's frozen counts and the data-sheet peaks) over the device
time a traced call and card of the kernels whose names carry one of the
configuration's ``pt_op_types`` (the lean and the full pseudo-transient
functors). The thermal kernel, one launch a call, counts in
``kernels_roofline`` only. None where the configuration names no such
types, and without their kernels' time, as on the CPU."""


def read(record):
    trace, types = record["trace"], record["config"].get("pt_op_types")
    if trace is None or not types or record["bound_s"] is None:
        return None
    us = sum(v["us"] for name, v in trace["kernels"].items() if any(t in name for t in types))
    if not us:
        return None
    return record["bound_s"] * 1e6 / (us / trace["calls"] / record.get("chips", 1)) * 100.0
