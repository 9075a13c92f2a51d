"""Cells updated a second over the window, in billions: H W n for every call
of the window over the host-clock time from the first call's start to the
last call's end."""


def read(record):
    return record["cells_per_call"] * record["calls"] / record["window_s"] / 1e9
