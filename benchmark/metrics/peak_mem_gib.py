"""The most device memory the process held over set-up and window
(``torch.cuda.max_memory_allocated``), less the benchmark's own kept grids,
which are allocated first and held throughout, in GiB. None off the card."""


def read(record):
    if not record["peak_bytes"]:
        return None
    return (record["peak_bytes"] - record["kept_bytes"]) / 2**30
