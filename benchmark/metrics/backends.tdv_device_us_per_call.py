"""Device time a traced call of the time-dependent value stream's batched
evaluation, in us: the profiler's device kernels inside the calls that are
not a ``<module>_kernel`` of the port's kernel modules, over the traced
calls and the cell's cards. Copies and fills (``Memcpy ...``, ``Memset ...``) are not counted:
the inline strategy evaluates the stream with elementwise kernels alone
(the host strategy's upload, a ``Memcpy HtoD``, is left out with them).
None where the configuration has no time-dependent value, and without
device operations, as on the CPU."""

COPIES = ("Memcpy", "Memset")


def read(record):
    trace = record["trace"]
    if trace is None or not record["config"].get("tdv") or not trace["kernels"]:
        return None
    port = [f"{module}_kernel" for module in trace["launches"]]
    us = sum(v["us"] for name, v in trace["kernels"].items()
             if not name.startswith(COPIES) and not any(k in name for k in port))
    return us / trace["calls"] / record.get("chips", 1)
