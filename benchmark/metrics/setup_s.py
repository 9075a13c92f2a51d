"""Seconds from the harness's first line to the window's first call: imports,
the CUDA context, loading (or building) the port's library, inputs made on
the card, the updater and its warm-up calls."""


def read(record):
    return record["setup_s"]
