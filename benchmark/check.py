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
(the difference itself where that is 0). A non-finite output reads
``inf``. The reference runs in float64 once the window has closed and the
program's state is freed.
"""

from __future__ import annotations

import math

import torch

__all__ = ["rel_err", "run_checks"]


def rel_err(program: dict[str, torch.Tensor], reference: dict[str, torch.Tensor]) -> float:
    """The largest relative gap over the fields (see the module docstring)."""
    worst = 0.0
    for name, ref in reference.items():
        got = program[name].to(torch.float64)
        ref = ref.to(torch.float64)
        if not bool(torch.isfinite(got).all()):
            return math.inf
        diff = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        worst = max(worst, diff / scale if scale > 0 else diff)
    return worst


def run_checks(reference, app, config: dict, traffic: dict, seed: int, kept: dict, device,
               dtype=torch.float64) -> dict[str, float]:
    """The numbers compared: ``kept`` holds the window's kept grids,
    ``chain`` (output of call ``chain_calls - 1``) and ``sample_in`` /
    ``sample_out`` (the drawn call's input and output)."""
    n = traffic["n_iterations"]
    inputs = app.make_inputs(traffic["height"], traffic["width"], seed, device)
    chained = reference.run(inputs, n * kept["chain_calls"], config, dtype)
    del inputs
    out = {"chain_err": rel_err(kept["chain"], chained)}
    del chained
    sampled = reference.run(kept["sample_in"], n, config, dtype)
    out["sample_err"] = rel_err(kept["sample_out"], sampled)
    return out
