"""The readings a cell's limits are set from, in one process on the card.

    python3 -m benchmark.readings --workload <cell> --seeds 1,2,3 \\
        --control-seeds 4,5,6 --fault-seeds 7 --seconds 10 [--control-seconds 3]

For each seed, one run of the program as the benchmark makes it, and the
numbers compared; then the control (the reference in bfloat16 in the
program's place, :func:`benchmark.faults.control`) and each fault of
:data:`benchmark.faults.FAULTS`, at the cell's own size. One JSON line a
run. The benchmark's own runs never run the control or the faults.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from .faults import FAULTS, control
from .run import run_cell
from .spec import Spec


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m benchmark.readings")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--fault-seeds", default="")
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--control-seconds", type=float, default=3.0)
    args = parser.parse_args(argv)
    spec = Spec()
    cell = spec.cell(args.workload)
    config, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    runs = [("program", s, None, args.seconds) for s in _seeds(args.seeds)]
    wrap = control(spec.reference(cell["config"]), config, traffic)
    runs += [("control_bf16", s, wrap, args.control_seconds) for s in _seeds(args.control_seeds)]
    runs += [(name, s, fault, args.control_seconds)
             for s in _seeds(args.fault_seeds) for name, fault in FAULTS.items()]
    for what, seed, wrap, seconds in runs:
        torch.cuda.reset_peak_memory_stats()
        result = run_cell(spec, args.workload, seed, seconds, False, wrap=wrap)
        line = {"workload": args.workload, "run": what, "seed": seed, "correct": result["correct"],
                "calls": result["attempted"], "checks": result["checks"],
                "metrics": {k: v["value"] for k, v in result["metrics"].items()}}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
