"""Bytes of halo strips a call copies between the blocks of a grid held on
several devices, in MB: the delta of the port's counter
``distributed.exchange_bytes`` over the span segment's profiled calls
(``benchmark.span_segment``), over the calls, / 1e6. None where nothing is
exchanged, as on one card."""

from benchmark.span_segment import read as segment


def read(record):
    seg = segment(record, __file__)
    prof = seg and seg["profiled"]
    if not prof or not prof["counters"].get("distributed.exchange_bytes"):
        return None
    return prof["counters"]["distributed.exchange_bytes"] / prof["calls"] / 1e6
