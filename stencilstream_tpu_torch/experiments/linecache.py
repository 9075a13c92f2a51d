"""The line-cache microbenchmarks' pass: skewed strips with per-level
carries, a zero carry at the top.

Wrapper of the CUDA kernel ``csrc/micro_linecache.cu``, which replaces the
TPU kernels of ``experiments/micro_linecache.py`` (``make_lc_kernel`` and
the ``pallas_call`` in ``run_lc.one_pass``) and ``experiments/
lc_bisect.py`` (``build``'s five scratch layouts), and its plain PyTorch
version.

What a pass computes. The input ``x`` is ``(Ha, W)``: ``H`` grid rows and
``Ha - H >= p`` rows of pad below them; ``hp = p``. Level arrays by grid row
``g``: ``L_0[g] = x[g]`` for ``g >= hp``, and ``L_{s+1}[g]`` is the Jacobi5
update of ``L_s[g-1]`` (north), ``L_s[g]`` (centre), ``L_s[g+1]`` (south),
and the centre's west and east neighbours (0 outside columns ``[0, W)``),
for ``g >= hp - s - 1``. The two rows above each level's first row are the
carry: zero before the first strip. Nothing bounds the bottom: the last
strip reads ``x``'s pad rows. The output's rows ``[0, H)`` are ``L_p``;
its pad rows are NaN (nothing writes them on the TPU: interpret mode shows
NaN). With ``alias`` the TPU kernel wrote into ``x``, so its pad rows were
``x``'s: the Hopper kernel has no in-place form, and :func:`linecache_pass`
copies ``x``'s pad rows into its result instead.
The TPU kernel walks strips of ``T`` rows top to bottom and carries each
level's last two rows to the next strip; the result does not depend on
``T`` but for two variants: ``noscratch`` zeroes the carry of every strip
(strips are independent), and ``*_noinit`` never initialises it, so rows
``[0, 2p)`` are undefined (NaN in the plain version, as in interpret mode).

Rounding: the centre's product, then one fused multiply-add a further tap,
in the script's order, as the port's ``jacobi5_general`` functor sums
(``csrc/ops/jacobi.cuh``), so that a micro_linecache pass equals the tile
pass bit for bit away from the top and bottom (``--check``). XLA on the
CPU contracts the interpreted TPU kernel otherwise, and not alike in every
cell, so the port agrees with it within a few ulps.

* On CPU tensors :func:`linecache_pass` runs :func:`linecache_pass_plain`.
* On CUDA tensors it launches the kernel, or raises.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..backends.cuda_lib import check, entry
from ..core.fma import fma_f32

__all__ = [
    "BISECT_WEIGHTS",
    "LINECACHE_WEIGHTS",
    "LineCacheVariant",
    "VARIANTS",
    "chunk_rows",
    "launches",
    "linecache_pass",
    "linecache_pass_plain",
    "pass_bytes",
    "pass_operations",
    "undefined_rows",
]

#: Kernel launches made by :func:`linecache_pass` (CUDA tensors only).
launches = 0

#: micro_linecache's (CN, WW_, WS, WE, W0) of (north, west, south, east,
#: centre), ``experiments/micro_linecache.py:39``: the ``jacobi5_general``
#: coefficients ``c0..c4``; rounded to float32, as the kernels take them.
LINECACHE_WEIGHTS = tuple(float(np.float32(c)) for c in (0.15, 0.2, 0.25, 0.1, 0.3))
#: lc_bisect's (W0, WN, WS, WW, WE) of (centre, north, south, west, east),
#: ``experiments/lc_bisect.py:10``; rounded to float32.
BISECT_WEIGHTS = tuple(float(np.float32(c)) for c in (0.15, 0.2, 0.25, 0.1, 0.3))


@dataclasses.dataclass(frozen=True)
class LineCacheVariant:
    """One TPU kernel variant and its Hopper counterpart."""

    #: the script under ``experiments/`` that defines it
    script: str
    #: p values the kernel is built for
    ps: tuple
    #: "jacobi5" (micro_linecache) or "bisect" (lc_bisect): coefficients,
    #: order and rounding
    order: str
    #: the carry: "first" (zeroed before the first strip), "every" (zeroed
    #: before every strip: no carry), "none" (never initialised)
    carry: str
    #: the carries' layout in shared memory (a Hopper knob of the same
    #: values): "3d" (p x 2 rows) or "2d" (rows 8s and 8s+1 of 8p). The
    #: kernel walks a strip in chunks and carries between them, so
    #: ``noscratch``, which has no scratch on the TPU, has one here too
    layout: str
    #: a persistent window with the carried rows written above the strip's
    #: (else the two top rows' taps read the carry)
    stitch: bool = False
    #: the output written through (strip, row) indices; needs T | Ha
    blocked: bool = False


_LC = dict(script="micro_linecache", ps=(8, 16, 32), order="jacobi5", carry="first", layout="3d")
_BISECT = dict(script="lc_bisect", ps=(8,), order="bisect")

#: Every variant, by name, in the order of ``csrc/micro_linecache.cu``'s
#: list (``SS_MICRO_LINECACHE_VARIANTS``; a variant's id is its position).
#: micro_linecache's kinds: ``lc`` plus ``s`` (stitch) and ``b`` (blocked);
#: its ``a`` (alias) is the ``alias`` argument.
VARIANTS = {
    "lc": LineCacheVariant(**_LC),
    "lcs": LineCacheVariant(**_LC, stitch=True),
    "lcb": LineCacheVariant(**_LC, blocked=True),
    "lcsb": LineCacheVariant(**_LC, stitch=True, blocked=True),
    "noscratch": LineCacheVariant(**_BISECT, carry="every", layout="3d"),
    "scratch3d": LineCacheVariant(**_BISECT, carry="first", layout="3d"),
    "scratch3d_noinit": LineCacheVariant(**_BISECT, carry="none", layout="3d"),
    "scratch2d": LineCacheVariant(**_BISECT, carry="first", layout="2d"),
    "scratch2d_noinit": LineCacheVariant(**_BISECT, carry="none", layout="2d"),
}


def undefined_rows(variant: str, p: int) -> int:
    """Rows at the top of the output that the variant leaves undefined
    (2p for an uninitialised carry, else 0)."""
    return 2 * p if VARIANTS[variant].carry == "none" else 0


def chunk_rows(T: int) -> int:
    """Rows the kernel walks at a time: the largest of 32, 16, 8, 4, 2
    that divides the strip (a strip boundary, where ``noscratch`` zeroes
    its carry, then falls on a chunk boundary)."""
    return next(r for r in (32, 16, 8, 4, 2) if T % r == 0)


def _check(x: torch.Tensor, name: str, H: int, T: int, p: int) -> LineCacheVariant:
    if name not in VARIANTS:
        raise ValueError(f"unknown line-cache variant {name!r}; the variants are {', '.join(VARIANTS)}")
    v = VARIANTS[name]
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"the line-cache pass takes a 2D float32 grid (got {x.dtype} {tuple(x.shape)})")
    Ha, _ = x.shape
    if p < 1 or T < 2 or T % 2 or H < T or H % T:
        raise ValueError(f"{H} rows need whole strips of an even T >= 2 rows (got T={T}) and p >= 1 (got {p})")
    if Ha < H + p:
        raise ValueError(f"the last strip reads {p} rows below the grid: x needs at least {H + p} rows, "
                         f"has {Ha}")
    if v.blocked and Ha % T:
        raise ValueError(f"the blocked output takes whole strips: T={T} must divide x's {Ha} rows")
    return v


def _update(v: LineCacheVariant, center, north, south, west, east) -> torch.Tensor:
    """One level's Jacobi5 update: the centre's product, then a fused
    multiply-add a further tap in the script's order."""
    if v.order == "jacobi5":
        cn, ww, ws, we, w0 = LINECACHE_WEIGHTS
        terms = ((north, cn), (west, ww), (south, ws), (east, we))
    else:
        w0, wn, ws, ww, we = BISECT_WEIGHTS
        terms = ((north, wn), (south, ws), (west, ww), (east, we))
    acc = center * w0
    for tap, c in terms:
        acc = fma_f32(tap, c, acc)
    return acc


def linecache_pass_plain(x: torch.Tensor, variant: str, *, H: int, T: int, p: int) -> torch.Tensor:
    """The plain PyTorch version of one pass: the TPU kernel's walk, strip
    by strip, on whole rows."""
    v = _check(x, variant, H, T, p)
    Ha, W = x.shape
    out = torch.full_like(x, math.nan)
    zero = torch.zeros(2, W, dtype=x.dtype, device=x.device)
    carry = [torch.full_like(zero, math.nan) if v.carry == "none" else zero] * p
    for j in range(H // T):
        if v.carry == "every":
            carry = [zero] * p
        own = x[j * T + p : j * T + p + T]
        for s in range(p):
            ext = torch.cat([carry[s], own])
            carry[s] = own[T - 2 :]
            center = ext[1 : T + 1]
            frame = torch.zeros_like(center[:, :1])
            west = torch.cat([frame, center[:, :-1]], 1)
            east = torch.cat([center[:, 1:], frame], 1)
            own = _update(v, center, ext[:T], own, west, east)
        out[j * T : j * T + T] = own
    return out


def variant_id(name: str) -> int:
    """A variant's position in ``csrc/micro_linecache.cu``'s list."""
    return list(VARIANTS).index(name)


@torch.no_grad()
def linecache_pass(x: torch.Tensor, variant: str, *, H: int, T: int, p: int, alias: bool = False,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """One pass of ``variant`` over ``x`` (``H`` grid rows and pad rows
    below): a new tensor, or ``out`` (of ``x``'s shape, not ``x``) written
    on the card. The kernel does not write in place: with ``alias`` the
    result's pad rows are copied from ``x``, as the TPU kernel's were when
    it wrote into ``x``. Raises for a geometry the variant does not take and, on the
    card, for a ``p`` its kernel is not built for."""
    global launches
    v = _check(x, variant, H, T, p)
    if x.device.type == "cpu":
        out = linecache_pass_plain(x, variant, H=H, T=T, p=p)
        return _keep_pad_rows(out, x, H) if alias else out
    if p not in v.ps:
        raise NotImplementedError(f"the line-cache kernel's {variant!r} is built for p in {v.ps}, not {p}")
    if not x.is_contiguous():
        raise ValueError("the line-cache pass takes a contiguous grid")
    Ha, W = x.shape
    if out is None:
        out = torch.empty_like(x)
    elif out.shape != x.shape or out.dtype != x.dtype or out.device != x.device or not out.is_contiguous() \
            or out.data_ptr() == x.data_ptr():
        raise ValueError("out must be a contiguous float32 tensor of x's shape on its device, and not x")
    fn = entry("ss_micro_linecache", "")
    with torch.cuda.device(x.device):
        code = fn(variant_id(variant), p, x.data_ptr(), out.data_ptr(), H, W, Ha, T, chunk_rows(T),
                  torch.cuda.current_stream(x.device).cuda_stream)
    check(code, f"line-cache microbenchmark kernel ({variant}, p={p})")
    launches += 1
    return _keep_pad_rows(out, x, H) if alias else out


def _keep_pad_rows(out: torch.Tensor, x: torch.Tensor, H: int) -> torch.Tensor:
    out[H:] = x[H:]
    return out


def pass_bytes(H: int, Ha: int, W: int) -> int:
    """Bytes a pass must move: the rows it reads (``[p, H + p)``, H of
    them) and all ``Ha`` rows it writes."""
    return 4 * (H + Ha) * W


def pass_operations(H: int, W: int, p: int) -> int:
    """Float32 operations of one pass (a fused multiply-add counts as two):
    nine a cell at each of ``p`` levels."""
    return 9 * p * H * W


def zero_pad(x: np.ndarray, rows: int) -> np.ndarray:
    """``x`` with ``rows`` zero rows below it, as the scripts pad their
    input."""
    return np.pad(x, ((0, rows), (0, 0)))
