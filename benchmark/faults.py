"""What is put in the program's place to show that the comparison fails.

* :func:`control`: the plain reference, computed in bfloat16, the precision
  below the configuration's float32;
* :data:`FAULTS`: the port's updater broken underneath, in each way a
  single-card stencil cell can be: a call that returns its state unchanged,
  half of the grid (the lower rows) left out of the update, and one answer
  altered where it is produced.

Each is a ``wrap(update, app)`` for :func:`benchmark.run.run_cell`. In a
cell of several blocks ``app.from_grid`` gives ``{(iy, ix): fields}``, and
a fault acts on each block (half of each block's rows left out; the first
block's answer altered); the control takes a grid of one block only.
"""

from __future__ import annotations

import torch

__all__ = ["control", "FAULTS"]


def _blocks(fields: dict) -> list[dict]:
    """The field dicts of a grid: its blocks', or its own."""
    return list(fields.values()) if isinstance(next(iter(fields)), tuple) else [fields]


def control(reference, config: dict, traffic: dict, dtype=torch.bfloat16):
    """The reference in ``dtype`` in the program's place."""

    def wrap(update, app):
        def call(grid):
            fields = app.from_grid(grid)
            if len(_blocks(fields)) > 1:
                raise ValueError("the control runs on a grid of one block")
            out = reference.run(fields, traffic["n_iterations"], config, dtype)
            return app.to_grid({k: v.to(fields[k].dtype) for k, v in out.items()})

        return call

    return wrap


def _unchanged(update, app):
    return lambda grid: grid


def _half_left_out(update, app):
    def call(grid):
        before = _blocks(app.from_grid(grid))
        out = update(grid)
        for old, new in zip(before, _blocks(app.from_grid(out))):
            for name, t in new.items():
                t[t.shape[0] // 2:] = old[name][t.shape[0] // 2:]
        return out

    return call


def _answer_altered(update, app):
    def call(grid):
        out = update(grid)
        t = next(iter(_blocks(app.from_grid(out))[0].values()))
        t[t.shape[0] // 3, t.shape[1] // 3] += 1.0
        return out

    return call


FAULTS = {"unchanged": _unchanged, "half_left_out": _half_left_out, "answer_altered": _answer_altered}
