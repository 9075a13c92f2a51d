"""Share of the traced window in which nothing ran on a card, in %: for
each card one less the union of its profiler device intervals over the
window from the first traced call's start to the last one's end, and the
mean of these over the cards."""


def read(record):
    trace = record["trace"]
    if trace is None or not trace["busy_us"]:
        return None
    idle = [1.0 - busy / trace["window_us"] for busy in trace["busy_us_by_card"].values()]
    return sum(idle) / len(idle) * 100.0
