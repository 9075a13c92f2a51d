"""The least time a call's work needs on the card.

The work is counted from the configuration's frozen counts, never from the
geometry that ran: ``ops_per_cell`` operations a cell and iteration (a
fused multiply-add counts as two), and ``bytes_read_per_cell`` plus
``bytes_written_per_cell`` once a call, whatever a kernel reads again.
The peaks are the data-sheet numbers of ``peaks.json``, without derate,
times the cell's ``chips``: a cell in blocks over its cards has them all::

    bound = max(H W n ops / (chips flop_per_s), H W (read + written) / (chips hbm_bytes_per_s))
"""

from __future__ import annotations

__all__ = ["peak_for", "bound_s"]


def peak_for(peaks: list[dict], kind: str) -> dict | None:
    """The peaks of the device named ``kind``, or ``None`` for a device the
    table does not hold."""
    for entry in peaks:
        if entry["match"] in kind:
            return entry
    return None


def bound_s(config: dict, traffic: dict, peak: dict, chips: int = 1) -> tuple[float, str]:
    """``(seconds, "operations" | "bytes")``: a call's bound on ``chips``
    cards and what sets it."""
    cells = traffic["height"] * traffic["width"]
    ops_s = (cells * traffic["n_iterations"] * config["ops_per_cell"]
             / (chips * peak[f"{config['dtype']}_flop_per_s"]))
    bytes_s = (cells * (config["bytes_read_per_cell"] + config["bytes_written_per_cell"])
               / (chips * peak["hbm_bytes_per_s"]))
    return (ops_s, "operations") if ops_s >= bytes_s else (bytes_s, "bytes")
