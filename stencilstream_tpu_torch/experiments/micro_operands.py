"""Microbenchmark: the cost of operand plumbing in the strip pass, on the card.

The port of ``experiments/micro_operands.py``. On the TPU it added, one at a
time, scalar SMEM operands (``smem10``), coefficients and the halo value
read from them (``coef``, ``hv``), an element-indexed output (``elemout``)
and the loss of the edge strips' select (``nowhere``) to the lean Jacobi5
strip kernel; ``all`` has all of them. On Hopper the scalars are kernel
arguments instead of literals and the output is written through a row
pointer instead of a 2D index (:data:`.strip.VARIANTS`, those of
``micro_operands``; ``csrc/micro_strip.cu``). The same grid, strips and
marginal rate over ``n2 - n1`` passes, timed by CUDA events; each line also
gives ms a pass, the share of the pass's bound and the card.

    python -m stencilstream_tpu_torch.experiments.micro_operands [--device cuda]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from . import strip
from .common import bound_ms, card_line, marginal, ping_pong, rate_line, resolve_device

SIZE = 8192
T = 128
HP = 8
P = 8
CASES = ("baseline", "smem10", "coef", "hv", "elemout", "nowhere", "all")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=SIZE)
    ap.add_argument("--n1", type=int, default=64)
    ap.add_argument("--n2", type=int, default=256)
    ap.add_argument("--device", default="cuda", help="cuda (default), or cpu for the plain versions")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    card = card_line(device)
    size = args.size
    x = torch.tensor(np.random.default_rng(0).random((size, size), np.float32), device=device)
    scalars = strip.StripScalars()  # the script's operands: its coefficients, hv 0, arange(16)[:10]
    failed = 0
    for name in CASES:
        try:
            run = ping_pong(lambda y, dst: strip.strip_pass(y, name, T=T, hp=HP, p=P, scalars=scalars, out=dst), x)
            t = marginal(run, args.n1, args.n2, device)
            b = bound_ms(strip.pass_bytes(size, size), strip.pass_operations(name, size, size, P))
            print(f"{name:10s}: {rate_line(size * size, P, t, b, card)}", flush=True)
        except Exception as e:  # the script's report: the case failed, the others go on
            failed += 1
            print(f"{name:10s}: FAILED {type(e).__name__}: {str(e).splitlines()[0][:120]}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
