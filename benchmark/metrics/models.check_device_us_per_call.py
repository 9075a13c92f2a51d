"""Device time a traced call and card of the convergence loop's checks, in us: the
profiler's device kernels inside the calls that are not a
``<module>_kernel`` of the port's kernel modules, nor copies or fills
(``Memcpy ...``, ``Memset ...``): the five masked maxima after each block
and their stack. None where the configuration has no convergence loop,
and without device operations, as on the CPU."""

COPIES = ("Memcpy", "Memset")


def read(record):
    trace = record["trace"]
    if trace is None or not record["config"].get("convergence_loop") or not trace["kernels"]:
        return None
    port = [f"{module}_kernel" for module in trace["launches"]]
    us = sum(v["us"] for name, v in trace["kernels"].items()
             if not name.startswith(COPIES) and not any(k in name for k in port))
    return us / trace["calls"] / record.get("chips", 1)
