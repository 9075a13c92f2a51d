"""Microbenchmark: the accumulation order of the Jacobi5 strip pass, on the card.

The port of ``experiments/micro_order.py``: four orders of the same five
products, ``centerfirst`` (``c4*x + c0*n + c1*w + c2*s + c3*e``), its
interleaved form ``inter_cf`` (the same rounding), ``centerlast`` (``c0*n +
c1*w + c2*s + c3*e + c4*x``) and ``grouped_nwse`` (the same rounding as
``centerlast``), each the strip kernel (``csrc/micro_strip.cu``) summing
in that order. The same grid, strips and marginal rate over ``n2 - n1``
passes, timed by CUDA events; each line also gives ms a pass, the share of
the pass's bound and the card. Unlike the script, importing this module
runs nothing.

    python -m stencilstream_tpu_torch.experiments.micro_order [--device cuda]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from . import strip
from .common import bound_ms, card_line, marginal, ping_pong, rate_line, resolve_device

SIZE, T, HP, P = 8192, 128, 8, 8
ORDERS = ("centerfirst", "centerlast", "inter_cf", "grouped_nwse")


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
    for variant in ORDERS:
        run = ping_pong(lambda y, dst: strip.strip_pass(y, variant, T=T, hp=HP, p=P, out=dst), x)
        t = marginal(run, args.n1, args.n2, device)
        b = bound_ms(strip.pass_bytes(size, size), strip.pass_operations(variant, size, size, P))
        print(f"{variant:12s}: {rate_line(size * size, P, t, b, card)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
