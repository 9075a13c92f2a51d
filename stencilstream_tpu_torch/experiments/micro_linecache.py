"""Microbenchmark: the line-cache (skewed) strip pass against the tile pass,
on the card.

The port of ``experiments/micro_linecache.py``. Variants are named as
there: ``lc<T>x<p>`` is the line-cache kernel (``csrc/micro_linecache.cu``)
with strips of T rows and p levels, with ``s`` after ``lc`` for the stitched
window, ``b`` for the blocked output and a trailing ``a`` for alias (the
result's pad rows are the input's); ``pad<T>x<p>`` is the baseline, the
port's tile pass (``csrc/tile_pass.cu``) at the ``jacobi5_general`` functor
with the script's coefficients, at the tile law's tile for p (T is the
TPU's strip and does not apply). The same grid, pad rows, pass counts
(``--iters`` iterations) and marginal rate over ``n2 - n1`` passes, timed by
CUDA events; each line also gives ms a pass, the share of the pass's bound
and the card. ``--check``: one pass of ``lc256x8`` must equal one tile pass
of p=8 bit for bit on rows ``[2p, H - 2p)``.

    python -m stencilstream_tpu_torch.experiments.micro_linecache \\
        [--size 8192] [--check] [--variants pad224x16,lc256x16,...] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..backends import cuda_lib
from ..backends.tile_pass import tile_pass
from ..backends.tiling import pick_config
from ..models import jacobi
from . import linecache as lc
from .common import bound_ms, card_line, marginal, ping_pong, rate_line, resolve_device

#: The script's coefficients in ``jacobi5_general``'s order (c0..c4) =
#: (north, west, south, east, centre): (CN, WW_, WS, WE, W0).
COEFS = [0.15, 0.2, 0.25, 0.1, 0.3]
DEFAULT_VARIANTS = "pad224x16,lc256x16,lc128x16,lc256x32,lc256x16a"


def parse_variant(v: str) -> tuple[str, int, int, bool]:
    """``(kind, T, p, alias)`` of a variant name, as the script parses it:
    kind ``pad`` or ``lc`` with its modifiers (``lcs``, ``lcb``, ``lcsb``)."""
    alias = v.endswith("a")
    core = v.rstrip("a")
    if core.startswith("pad"):
        T, p = core[3:].split("x")
        return "pad", int(T), int(p), False
    head, mods = core[2:], ""
    while head and head[0] in "sb":
        mods += head[0]
        head = head[1:]
    T, p = head.split("x")
    return f"lc{mods}", int(T), int(p), alias


def tile_pass_run(x: torch.Tensor, p: int):
    """(one tile pass of p as ``step(src, dst)``, its tile): Jacobi5 at the
    script's coefficients, halo 0, the tile law's tile for this grid."""
    H, W = x.shape
    tf = jacobi.make_kernel("jacobi5_general", COEFS)
    th, tw, _ = pick_config(H, W, 1, 1, p, 8, cuda_lib.device_limits(x.device), iters_per_pass=p)
    kw = dict(i_start=0, offset=0, n_iterations=p, iters_per_pass=p, tile=(th, tw))
    return (lambda y, dst: tile_pass(y, tf, 0.0, out=dst, **kw)), (th, tw)


def check(x0: np.ndarray, device: torch.device) -> float:
    """Largest difference on rows ``[2p, H - 2p)`` between one line-cache
    pass at T=256, p=8 and one tile pass of p=8 (the script's check)."""
    p, H = 8, x0.shape[0]
    got = lc.linecache_pass(torch.tensor(lc.zero_pad(x0, 16), device=device), "lc", H=H, T=256, p=p)
    step, _ = tile_pass_run(torch.tensor(x0, device=device), p)
    want = step(torch.tensor(x0, device=device), torch.empty_like(got[:H]))
    inner = slice(2 * p, H - 2 * p)
    return float((got[:H][inner] - want[inner]).abs().max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=8192)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--variants", type=str, default=DEFAULT_VARIANTS)
    ap.add_argument("--iters", type=int, default=2048)
    ap.add_argument("--device", default="cuda", help="cuda (default), or cpu for the plain versions")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    card = card_line(device)
    H = args.size
    x0 = np.random.default_rng(0).random((H, H), np.float32)
    if args.check:
        err = check(x0, device)
        print(f"interior max err (rows 16:{H - 16}): {err:.3e} [{card}]", flush=True)
        assert err == 0.0, "linecache interior mismatch"
        return 0

    failed = 0
    for v in args.variants.split(","):
        kind, T, p, alias = parse_variant(v)
        label = f"{kind} T={T} p={p}{' alias' if alias else ''}"
        try:
            n1, n2 = max(args.iters // p // 4, 1), max(args.iters // p, 2)
            if kind.startswith("lc"):
                pad = T if "b" in kind else ((p + 7) // 8) * 8
                x = torch.tensor(lc.zero_pad(x0, pad), device=device)
                step = lambda y, dst: lc.linecache_pass(y, kind, H=H, T=T, p=p, alias=alias, out=dst)  # noqa: E731
                b = bound_ms(lc.pass_bytes(H, H + pad, H), lc.pass_operations(H, H, p))
            else:
                x = torch.tensor(x0, device=device)
                step, tile = tile_pass_run(x, p)
                label += f" tile={tile[0]}x{tile[1]}"
                b = bound_ms(8 * H * H, jacobi.make_kernel("jacobi5_general", COEFS).n_operations * p * H * H)
            t = marginal(ping_pong(step, x), n1, n2, device)
            print(f"{label:24s}: {rate_line(H * H, p, t, b, card)}", flush=True)
        except Exception as e:  # the script's report: the variant failed, the others go on
            failed += 1
            print(f"{label:24s}: FAILED {type(e).__name__}: {str(e).splitlines()[0][:140]}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
