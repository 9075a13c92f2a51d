"""The port's own path in the precision below the configuration's, in the
program's place, as readings of a cell's limits, on the card.

    python3 -m benchmark.readings_below --workload <cell> --seeds 1,2,3 --seconds 3

The cell's app gives that path as ``precision_below(config, traffic)``, a
``wrap`` for :func:`benchmark.run.run_cell` (``apps/convection.py``: the
float32 timestep in place of the float64 one). One JSON line a seed, as
``python3 -m benchmark.readings`` prints its runs; the limits must fail
each.
"""

from __future__ import annotations

import argparse
import json
import sys

if __name__ == "__main__":  # before torch is imported: the runs see their cell's cards alone
    from .pin import pin

    pin(sys.argv[1:])

import torch  # noqa: E402

from .run import run_cell  # noqa: E402
from .spec import Spec  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m benchmark.readings_below")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=3.0)
    args = parser.parse_args(argv)
    spec = Spec()
    cell = spec.cell(args.workload)
    config, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    app = spec.app(cell["config"])
    if not hasattr(app, "precision_below"):
        print(f"the app of {cell['config']!r} gives no path below its precision", file=sys.stderr)
        return 1
    for seed in (int(s) for s in args.seeds.split(",") if s):
        for card in range(torch.cuda.device_count()):
            torch.cuda.reset_peak_memory_stats(card)
        result = run_cell(spec, args.workload, seed, args.seconds, False,
                          wrap=app.precision_below(config, traffic))
        line = {"workload": args.workload, "run": "port_below", "seed": seed, "correct": result["correct"],
                "calls": result["attempted"], "checks": result["checks"]}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
