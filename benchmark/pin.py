"""A run sees its cell's cards and no others.

The entry points call :func:`pin` with their arguments before ``torch`` is
imported: it sets ``CUDA_VISIBLE_DEVICES`` to the first ``chips`` cards of
the cell named by ``--workload``, taken from the variable's current value
where it is set, else ``0 .. chips - 1``. So ``auto`` and ``distributed``'s
default mesh count exactly the cell's cards on a host that has more. This
module imports no ``torch``.
"""

from __future__ import annotations

import os

from .spec import Spec

__all__ = ["pin", "visible_cards"]


def visible_cards(chips: int, current: str | None) -> str:
    """The value of ``CUDA_VISIBLE_DEVICES`` for a cell of ``chips`` cards,
    given its value now (``None`` where it is not set)."""
    if current is None:
        return ",".join(str(i) for i in range(chips))
    return ",".join([c.strip() for c in current.split(",") if c.strip()][:chips])


def _workload(argv: list[str]) -> str | None:
    for i, arg in enumerate(argv):
        if arg == "--workload" and i + 1 < len(argv):
            return argv[i + 1]
        if arg.startswith("--workload="):
            return arg.split("=", 1)[1]
    return None


def pin(argv: list[str], environ=os.environ) -> None:
    """Set ``CUDA_VISIBLE_DEVICES`` in ``environ`` for the cell that ``argv``
    names. Without ``--workload``, or for a cell ``BENCHMARK.json`` does not
    hold, it leaves the variable alone: the entry point reports the fault."""
    name = _workload(argv)
    if name is None:
        return
    try:
        chips = Spec().cell(name)["chips"]
    except (KeyError, OSError):
        return
    environ["CUDA_VISIBLE_DEVICES"] = visible_cards(chips, environ.get("CUDA_VISIBLE_DEVICES"))
