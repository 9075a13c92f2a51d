"""A cell's whole simulation, call after call, against the plain reference at
chosen frames, on the card.

    python3 -m benchmark.axis --workload fdtd-2048 --seed <n> \\
        --frames 1,70,71,140,141,150 [--calls 150]

The cell's updater runs ``--calls`` chained calls (default the traffic's
``calls_per_run``) from the seed's inputs, as the benchmark's window does
before it starts again. At each frame ``f`` (1-based), the reference runs in
float64 from the program's own input of call ``f`` through that call's
iterations, and its output is compared with the program's output of call
``f`` as :func:`benchmark.check.rel_err` compares them. For ``fdtd-2048``
those frames are the first call, the calls around the source's cutoff
(iteration 191,482, call 70) and the detect switch (iteration 382,965,
call 140), and the last of the 15 tau: the points that a 10 s window of the
cell never reaches.

One JSON line a frame, then one with the verdict; exits 1 where a frame's
error is not below the cell's ``sample_err`` limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from .check import rel_err
from .spec import Spec

__all__ = ["check_axis", "main"]


def check_axis(spec: Spec, cell_name: str, seed: int, frames: list[int], calls: int | None = None, *,
               device: str = "cuda", wrap=None) -> list[dict]:
    """The frames' records: ``frame``, the call's first ``iteration`` and
    ``err``. ``wrap(update, app)`` puts another updater in the program's
    place, as in :func:`benchmark.run.run_cell`."""
    cell = spec.cell(cell_name)
    config, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    app, reference = spec.app(cell["config"]), spec.reference(cell["config"])
    n = traffic["n_iterations"]
    calls = calls or traffic["calls_per_run"]
    if not frames or min(frames) < 1 or max(frames) > calls:
        raise ValueError(f"frames must lie in 1..{calls}")
    dev = torch.device(device)
    update = app.make_update(config, traffic)
    if wrap is not None:
        update = wrap(update, app)
    grid = app.to_grid(app.make_inputs(traffic["height"], traffic["width"], seed, dev))
    kept = {}
    for call in range(1, calls + 1):
        if call in frames:
            before = {k: v.clone() for k, v in app.from_grid(grid).items()}
        grid = update(grid)
        if call in frames:
            kept[call] = (before, {k: v.clone() for k, v in app.from_grid(grid).items()})
    del grid
    records = []
    for call in sorted(kept):
        before, after = kept.pop(call)
        want = reference.run(before, n, config, torch.float64)
        records.append({"frame": call, "iteration": (call - 1) * n, "err": rel_err(after, want)})
    return records


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m benchmark.axis")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--frames", required=True, help="1-based calls, comma-separated")
    parser.add_argument("--calls", type=int, default=None)
    args = parser.parse_args(argv)
    spec = Spec()
    limit = spec.limits(args.workload)["sample_err"]
    t0 = time.perf_counter()
    records = check_axis(spec, args.workload, args.seed, [int(f) for f in args.frames.split(",") if f],
                         args.calls)
    for r in records:
        print(json.dumps({"workload": args.workload, "seed": args.seed, **r, "limit": limit}), flush=True)
    ok = all(r["err"] < limit for r in records)
    print(json.dumps({"workload": args.workload, "seed": args.seed, "correct": ok,
                      "worst": max(r["err"] for r in records), "limit": limit,
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
