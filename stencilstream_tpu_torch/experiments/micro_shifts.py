"""Microbenchmark: the cost of neighbour shifts and halo masks in a p-fused
Jacobi5-style strip pass, on the card.

The port of ``experiments/micro_shifts.py``: the same variants (see
:data:`.strip.VARIANTS`, those of ``micro_shifts``), the same grid, strips
and timing (the marginal rate over ``n2 - n1`` passes), each pass one launch
of the strip kernel (``csrc/micro_strip.cu``), timed by CUDA events. Each
line also gives ms a pass, the share of the pass's bound and the card.

    python -m stencilstream_tpu_torch.experiments.micro_shifts \\
        [--size 8192] [--iters 1024] [--strips 128,256] [--ps 8,16] \\
        [--variants wrap,hoisted,inline,concat] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from . import strip
from .common import bound_ms, card_line, marginal, ping_pong, rate_line, resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=1024)
    ap.add_argument("--strips", type=str, default="128,256")
    ap.add_argument("--ps", type=str, default="8,16")
    ap.add_argument("--variants", type=str, default="wrap,hoisted,inline,concat")
    ap.add_argument("--device", default="cuda", help="cuda (default), or cpu for the plain versions")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    card = card_line(device)
    size = args.size
    x = torch.tensor(np.random.default_rng(0).random((size, size), np.float32), device=device)
    failed = 0
    for T in [int(s) for s in args.strips.split(",")]:
        for p in [int(s) for s in args.ps.split(",")]:
            hp = ((p + 7) // 8) * 8  # the script's halo, whole sublanes
            n1 = max(args.iters // p // 4, 1)
            n2 = max(args.iters // p, 2)
            for variant in args.variants.split(","):
                try:
                    run = ping_pong(lambda y, dst: strip.strip_pass(y, variant, T=T, hp=hp, p=p, out=dst), x)
                    t = marginal(run, n1, n2, device)
                    ops = strip.pass_operations(variant, size, size, p)
                    b = bound_ms(strip.pass_bytes(size, size), ops)
                    print(f"T={T:4d} p={p:3d} {variant:8s}: {rate_line(size * size, p, t, b, card)}", flush=True)
                except Exception as e:  # the script's report: the variant failed, the sweep goes on
                    failed += 1
                    print(f"T={T:4d} p={p:3d} {variant:8s}: FAILED {type(e).__name__}: "
                          f"{str(e).splitlines()[0][:120]}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
