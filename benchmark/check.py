"""The comparison that decides ``correct``.

Two numbers a run, each against its limit from ``workloads/<cell>.json``:

* ``chain_err``: the output of the window's second call against the plain
  reference run from the seed's inputs through both calls' iterations. It
  checks the start (the updater on the inputs the benchmark made) and the
  chaining of one call's output into the next;
* ``sample_err``: one call drawn from the seed among all the window's
  calls (a reservoir of one), its output against the reference run from
  that call's input. The reference follows the program from the program's
  own state here: following the whole window would take longer than the
  window.

Each is the largest, over the cell's fields, of the largest absolute
difference over the grid divided by the largest absolute reference value
over the grid (the difference itself where that is 0). A non-finite output
reads ``inf``. The reference runs in float64 once the window has closed and
the program's state is freed.

A grid of one block is compared whole. A grid in blocks over cards
(:mod:`benchmark.layout`) is compared block by block, each on its card: the
reference's input is the block widened by ``m = iterations x radius x
sub_steps`` on every side, clipped to the grid and gathered from the kept
blocks, and the reference runs it with ``origin`` (the widened block's
first row and column) and ``extent`` (the grid's size). A cell of the
widened block lies at least ``m`` from a cut the reference treats as an
edge, so the block's own cells are the whole grid's, bit for bit. The
largest difference and the largest reference value are each taken over
all blocks before they are divided.
"""

from __future__ import annotations

import inspect
import math

import torch

__all__ = ["Gap", "compare", "margin", "rel_err", "require_blocks", "run_checks"]


class Gap:
    """The largest relative gap, gathered block by block (see the module
    docstring)."""

    def __init__(self):
        self.diff, self.scale, self.finite = {}, {}, True

    def add(self, program: dict[str, torch.Tensor], reference: dict[str, torch.Tensor]) -> None:
        for name, ref in reference.items():
            got = program[name].to(torch.float64)
            ref = ref.to(torch.float64)
            if not bool(torch.isfinite(got).all()):
                self.finite = False
                return
            self.diff[name] = max(self.diff.get(name, 0.0), float((got - ref).abs().max()))
            self.scale[name] = max(self.scale.get(name, 0.0), float(ref.abs().max()))

    def value(self) -> float:
        if not self.finite:
            return math.inf
        worst = 0.0
        for name, diff in self.diff.items():
            scale = self.scale[name]
            worst = max(worst, diff / scale if scale > 0 else diff)
        return worst


def rel_err(program: dict[str, torch.Tensor], reference: dict[str, torch.Tensor]) -> float:
    """The largest relative gap over the fields of one grid."""
    gap = Gap()
    gap.add(program, reference)
    return gap.value()


def require_blocks(reference, config: dict) -> None:
    """Refuses a configuration that does not state its ``sub_steps``, and a
    reference without ``origin`` and ``extent``: neither can check a grid
    in blocks."""
    if "sub_steps" not in config:
        raise ValueError(f"the configuration {config.get('name')!r} runs in blocks and must state its sub_steps")
    if not {"origin", "extent"} <= set(inspect.signature(reference.run).parameters):
        raise ValueError(f"the reference of {config.get('name')!r} has no origin and extent: "
                         "it checks only a grid of one block")


def margin(config: dict, iterations: int) -> int:
    """Rows and columns a block is widened by for ``iterations``: the reach
    of that many iterations."""
    return iterations * config["radius"] * config["sub_steps"]


def compare(reference, config: dict, n: int, layout, source, program: dict, m: int,
            dtype=torch.float64) -> float:
    """``program``'s blocks against the reference run ``n`` iterations from
    ``source(key)``'s blocks, each block widened by ``m``."""
    gap = Gap()
    if layout.whole:
        (key,) = layout.blocks
        want = reference.run(source(key), n, config, dtype)
        gap.add(program[key], want)
        return gap.value()
    H, W = layout.height, layout.width
    for key, (rows, cols, device) in layout.blocks.items():
        y0, x0 = max(0, rows.start - m), max(0, cols.start - m)
        wide = layout.gather(source, range(y0, min(H, rows.stop + m)), range(x0, min(W, cols.stop + m)), device)
        want = reference.run(wide, n, config, dtype, origin=(y0, x0), extent=(H, W))
        del wide
        own = (slice(rows.start - y0, rows.stop - y0), slice(cols.start - x0, cols.stop - x0))
        gap.add(program[key], {name: t[own] for name, t in want.items()})
        del want
    return gap.value()


def run_checks(reference, config: dict, traffic: dict, kept: dict, layout, inputs,
               dtype=torch.float64) -> dict[str, float]:
    """The numbers compared: ``kept`` holds the window's kept grids as
    blocks, ``chain`` (output of call ``chain_calls - 1``) and
    ``sample_in`` / ``sample_out`` (the drawn call's input and output);
    ``inputs(key)`` makes a block of the seed's inputs on its device."""
    n, chain_n = traffic["n_iterations"], traffic["n_iterations"] * kept["chain_calls"]
    m_chain = m_sample = 0
    if not layout.whole:
        require_blocks(reference, config)
        m_chain, m_sample = margin(config, chain_n), margin(config, n)
    out = {"chain_err": compare(reference, config, chain_n, layout, inputs, kept["chain"], m_chain, dtype)}
    out["sample_err"] = compare(reference, config, n, layout, kept["sample_in"].__getitem__, kept["sample_out"],
                                m_sample, dtype)
    return out
