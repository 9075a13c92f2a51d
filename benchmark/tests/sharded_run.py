"""HotSpot 8192^2 in blocks over a mesh of cards, run through the benchmark's
harness outside its cells: a check of the harness on several cards.

    python3 benchmark/tests/sharded_run.py --seed <n> --seconds <s> --out <dir> [--mesh 2,2]
        [--side 8192] [--device cuda]

It copies ``BENCHMARK.json`` and ``benchmark/`` into ``--out`` (a directory
git ignores, such as ``_archive/sharded``) with one more configuration, HotSpot's with
``sub_steps`` 1, whose app is ``sharded_hotspot.py`` (the port's
``distributed`` backend), and one more cell: 8192^2 (``--side``), 200
iterations a call, the mesh on as many cards, ``hotspot-8192``'s limits.
``--device cpu`` runs every block on the CPU, as a rehearsal. It runs the cell with
``benchmark.run.run_cell``, untraced and then traced, each in its own
process, and prints one JSON line each: the result, and the numbers of the
blocked check beside those of the whole check of the same kept data
(gathered onto the first card).
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
CELL = "hotspot-8192-sharded"


def make_root(out: Path, mesh: list[int], side: int) -> None:
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    shutil.copy(ROOT / "BENCHMARK.json", out / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", out / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = out / "benchmark"
    cfg = json.loads((bench / "configs/hotspot.json").read_text())
    cfg.update(name="hotspot_sharded", sub_steps=1)
    (bench / "configs/hotspot_sharded.json").write_text(json.dumps(cfg))
    shutil.copy(HERE / "sharded_hotspot.py", bench / "apps/hotspot_sharded.py")
    shutil.copy(bench / "reference/hotspot.py", bench / "reference/hotspot_sharded.py")
    traffic = dict(json.loads((bench / "traffic/sq8192-n200-auto.json").read_text()),
                   height=side, width=side, backend="distributed", mesh=mesh)
    (bench / f"traffic/{CELL}.json").write_text(json.dumps(traffic))
    shutil.copy(bench / "workloads/hotspot-8192.json", bench / f"workloads/{CELL}.json")
    spec = json.loads((out / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "hotspot_sharded", "source": "https://github.com/pc2/StencilStream", "reduced": [],
                            "file": "benchmark/configs/hotspot_sharded.json", "why": "a check of the harness"})
    spec["workloads"].append({"name": CELL, "config": "hotspot_sharded", "traffic": CELL,
                              "chips": mesh[0] * mesh[1], "why": "a check of the harness"})
    (out / "BENCHMARK.json").write_text(json.dumps(spec))


def one_run(out: Path, seed: int, seconds: float, traced: bool, device: str) -> dict:
    """In this process: the cell's run, with the whole check beside the blocked one."""
    sys.path[:0] = [str(out), str(ROOT), str(HERE)]
    from benchmark.pin import pin

    pin(["--workload", CELL])
    import torch

    from benchmark import run as bench_run
    from benchmark.check import run_checks
    from benchmark.layout import Layout
    from benchmark.spec import Spec
    from sharded_hotspot import gather

    whole_numbers = {}

    def both_checks(reference, config, traffic, kept, layout, inputs, **kw):
        blocked = run_checks(reference, config, traffic, kept, layout, inputs, **kw)
        first = layout.devices()[0]

        def whole(blocks):
            return gather({k: {f: t.to(first) for f, t in v.items()} for k, v in blocks.items()})

        grids = {name: {(0, 0): whole(kept[name])} for name in ("chain", "sample_in", "sample_out")}
        grids["chain_calls"] = kept["chain_calls"]
        start = whole({key: inputs(key) for key in layout.blocks})
        whole_numbers.update(run_checks(reference, config, traffic, grids,
                                        Layout(layout.height, layout.width, (1, 1), [first]), lambda key: start, **kw))
        return blocked

    bench_run.run_checks = both_checks
    result = bench_run.run_cell(Spec(out), CELL, seed, seconds, traced, device=device)
    blocked = {k: v["value"] for k, v in result["checks"].items()}
    return {"traced": traced, "seed": seed, "cards": torch.cuda.device_count(), "correct": result["correct"],
            "calls": result["attempted"], "metrics": {k: v["value"] for k, v in result["metrics"].items()},
            "device": result["device"], "blocked": blocked, "whole": whole_numbers,
            "equal_bit_for_bit": blocked == whole_numbers}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 benchmark/tests/sharded_run.py")
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=5.0)
    parser.add_argument("--mesh", default="2,2")
    parser.add_argument("--out", required=True)
    parser.add_argument("--side", type=int, default=8192)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--traced", type=int, choices=(0, 1), default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    out = Path(args.out).resolve()
    if args.traced is not None:  # one run, in this process
        print(json.dumps(one_run(out, args.seed, args.seconds, bool(args.traced), args.device)), flush=True)
        return 0
    make_root(out, [int(m) for m in args.mesh.split(",")], args.side)
    rc = 0
    for traced in (0, 1):
        proc = subprocess.run([sys.executable, __file__, "--seed", str(args.seed), "--seconds", str(args.seconds),
                               "--out", str(out), "--device", args.device, "--traced", str(traced)])
        rc = rc or proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
