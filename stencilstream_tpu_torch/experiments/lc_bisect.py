"""Build and run one scratch layout of the line-cache strip kernel, on the card.

The port of ``experiments/lc_bisect.py``, which bisected a Mosaic compile
hang over five layouts of the kernel's carry: ``noscratch`` (a zero carry
for every strip), ``scratch3d`` and ``scratch2d`` (a (p, 2, W) or an (8p,
W) carry, zeroed before the first strip) and their ``_noinit`` forms (never
zeroed: strip 0's rows [0, 2p) undefined). On Hopper each is a layout of
the line-cache kernel's carry in shared memory (``csrc/micro_linecache.cu``);
nothing hangs to bisect, so this is a build-and-run check of one variant at
the script's 1024^2, p=8, strips of 128: it prints ``"<variant>: OK in X
s"`` for the first call (the build included) and then ms a pass, timed by
CUDA events, with the share of the pass's bound and the card.

    python -m stencilstream_tpu_torch.experiments.lc_bisect scratch3d [--device cuda]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from . import linecache as lc
from .common import bound_ms, card_line, chain_seconds, ping_pong, resolve_device

H = Wd = 1024
P = 8
T = 128
PAD = 8
VARIANTS = ("noscratch", "scratch3d", "scratch3d_noinit", "scratch2d", "scratch2d_noinit")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variant", choices=VARIANTS)
    ap.add_argument("--passes", type=int, default=100, help="passes timed after the first call")
    ap.add_argument("--device", default="cuda", help="cuda (default), or cpu for the plain versions")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    card = card_line(device)
    x = torch.tensor(lc.zero_pad(np.random.default_rng(0).random((H, Wd), np.float32), PAD), device=device)
    t0 = time.perf_counter()
    out = lc.linecache_pass(x, args.variant, H=H, T=T, p=P)
    float(out[0, 0])
    print(f"{args.variant}: OK in {time.perf_counter() - t0:.1f}s", flush=True)
    run = ping_pong(lambda y, dst: lc.linecache_pass(y, args.variant, H=H, T=T, p=P, out=dst), x)
    ms = chain_seconds(run, args.passes, device) / args.passes * 1e3
    b, by = bound_ms(lc.pass_bytes(H, H + PAD, Wd), lc.pass_operations(H, Wd, P))
    print(f"{args.variant}: {ms:.4f} ms a pass = {b / ms:.1%} of its bound {b:.4f} ms ({by}), "
          f"{args.passes} passes [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
