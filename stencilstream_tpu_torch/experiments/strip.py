"""The strip microbenchmarks' pass: ``p`` fused Jacobi5-style sub-steps on
windows of full-width rows, one window per strip.

Wrapper of the CUDA kernel ``csrc/micro_strip.cu``, which replaces the TPU
kernels of three microbenchmarks in ``experiments/`` (``make_kernel`` and
the ``pallas_call`` in ``run.one_pass`` of ``micro_shifts.py``,
``micro_operands.py`` and ``micro_order.py``), and its plain PyTorch version.

What a pass computes. Let the grid be ``H x W`` with ``n_s = H / T`` strips.
Window ``i`` starts at row ``org(i) = clip(i*T - hp, 0, H - (T + 2*hp))``
and holds ``win = T + 2*hp`` rows and every column. The pass runs ``p``
sub-steps on each window in isolation and writes window rows ``[off, off +
T)`` to the strip's rows ``[i*T, i*T + T)``: ``off`` is 0 for the first
strip, ``2*hp`` for the last and ``hp`` for the others, except where the
variant says ``shrink`` (``p`` for every strip) or ``middle`` (``hp``).
Those two shift the edge strips, as the TPU kernels do. Outside the window
(rows) and the grid (columns) a tap is either the window's or the grid's
other side (``wrap``: a torus) or the halo value (``zero``: 0, or the
``hv`` argument), at every sub-step. The microbenchmarks computed some of
this on purpose wrongly at the edges; it is still a function of the input,
and the port computes the same one.

Rounding. Each sub-step sums its weighted taps left to right in the
variant's order. Where XLA on the CPU contracts a multiply-add of the TPU
kernel (JAX's interpret mode, the oracle of the tests), the port fuses it
too, with :func:`~stencilstream_tpu_torch.core.fma.fma_f32` here and
``__fmaf_rn`` in the kernel (built with ``-fmad=false``). In one sub-step
XLA contracts a product whose tap is not the result of a select
(``jnp.where``): the first addition fuses the first term's product if it
may, else the second's; each later addition fuses its own term's product if
it may. Over several fused sub-steps XLA contracts some cells otherwise, so
the port equals JAX bit for bit in some variants and within a few ulps in
the others; the kernel equals its plain version exactly.

* On CPU tensors :func:`strip_pass` runs :func:`strip_pass_plain`.
* On CUDA tensors it launches the kernel, or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..backends.cuda_lib import check, entry
from ..core.fma import fma_f32

__all__ = [
    "COMPOSITE_TERMS",
    "StripScalars",
    "StripVariant",
    "VARIANTS",
    "core_offset",
    "launches",
    "pass_bytes",
    "pass_operations",
    "strip_pass",
    "strip_pass_plain",
    "window_origin",
]

#: Kernel launches made by :func:`strip_pass` (CUDA tensors only).
launches = 0

#: micro_shifts' weights (W0, WN, WS, WW, WE) of (center, north, south,
#: west, east), ``experiments/micro_shifts.py:31``; micro_operands' and
#: micro_order's coefficients (c0..c4) of (north, west, south, east,
#: center), ``micro_operands.py:47``, ``micro_order.py:13``: the same five
#: numbers.
COEFS = (0.15, 0.2, 0.25, 0.1, 0.3)
#: The same, rounded to float32, as the kernel's literals.
COEFS_F32 = tuple(float(np.float32(c)) for c in COEFS)
#: The extra scalar operands micro_operands hands its kernel: the first
#: ten of ``jnp.arange(16)``.
EXTRAS = tuple(float(v) for v in range(10))
#: micro_shifts' ``fma`` variant: ``x = a_j * x + b_j``, j = 0..4.
FMA_TERMS = tuple((float(np.float32(0.9997 + 0.0001 * j)), float(np.float32(1e-7 * (j + 1)))) for j in range(5))
#: micro_shifts' ``shiftonly`` variant: ``0.249 * (n + s + w + e)``.
SHIFT_ONLY_WEIGHT = float(np.float32(0.249))


def _composite_terms() -> tuple:
    """micro_shifts' 13-point weights of two Jacobi5 steps
    (``micro_shifts.py:57-68``, float64 sums in its loop order, rounded to
    float32) as ``(dy, dx, weight)`` in the order its loop sums them."""
    w0, wn, ws, ww, we = COEFS
    w1 = np.zeros((5, 5))
    w1[2, 2], w1[1, 2], w1[3, 2], w1[2, 1], w1[2, 3] = w0, wn, ws, ww, we
    w2 = np.zeros((5, 5))
    for dy in range(-1, 2):
        for dx in range(-1, 2):
            if w1[2 + dy, 2 + dx]:
                for ey in range(-1, 2):
                    for ex in range(-1, 2):
                        if w1[2 + ey, 2 + ex]:
                            w2[2 + dy + ey, 2 + dx + ex] += w1[2 + dy, 2 + dx] * w1[2 + ey, 2 + ex]
    return tuple((dy, dx, float(np.float32(w2[2 + dy, 2 + dx])))
                 for dy in range(-2, 3) for dx in range(-2, 3) if w2[2 + dy, 2 + dx])


#: The composite two-step stencil: ``(dy, dx, float32 weight)``, summed in
#: this order.
COMPOSITE_TERMS = _composite_terms()

#: The five-tap sums by update kind: the taps in the order summed, and the
#: index into :data:`COEFS` of each one's coefficient. Taps: x (center), n,
#: s, w, e.
ORDERS = {
    "shifts": ("xnswe", (0, 1, 2, 3, 4)),  # W0*x + WN*n + WS*s + WW*w + WE*e
    "center_first": ("xnwse", (4, 0, 1, 2, 3)),  # c4*x + c0*n + c1*w + c2*s + c3*e
    "center_last": ("nwsex", (0, 1, 2, 3, 4)),  # c0*n + c1*w + c2*s + c3*e + c4*x
}


@dataclasses.dataclass(frozen=True)
class StripVariant:
    """One TPU kernel variant and its Hopper counterpart."""

    #: the script under ``experiments/`` that defines it
    script: str
    #: p values the kernel is built for
    ps: tuple
    #: a torus across the window's rows (else the halo value outside it)
    rows_wrap: bool
    #: a torus across the grid's columns (else the halo value outside them)
    cols_wrap: bool
    #: "shifts", "center_first", "center_last", "composite", "fma", "shift_only"
    update: str
    #: the taps the TPU kernel takes through a select (never contracted):
    #: letters of "nswe", or "x" for the composite's taps off its centre
    #: column
    selects: str
    #: window rows written: "edges" (0, hp, 2*hp), "shrink" (p), "middle" (hp)
    out: str
    #: how the kernel keeps masked cells at the halo value (a Hopper knob of
    #: the same values): "frame" (written once, never recomputed),
    #: "hoisted" (predicates computed once per CTA), "inline" (recomputed
    #: every sub-step), "none" (no masked axis)
    mask: str
    #: coefficients from kernel arguments instead of literals
    coef_args: bool = False
    #: the halo value from a kernel argument instead of 0
    hv_arg: bool = False
    #: extra scalar arguments folded in as ``+ 0 * sum``
    n_extra: int = 0
    #: the core written through a row pointer instead of a 2D index
    row_pointer: bool = False

    def fused(self) -> tuple:
        """Per summed term, whether XLA contracts its product (the
        composite's 13 terms, or the five of its order)."""
        if self.update == "composite":
            return tuple(not (dx and "x" in self.selects) for _, dx, _ in COMPOSITE_TERMS)
        if self.update not in ORDERS:
            return ()
        return tuple(t == "x" or t not in self.selects for t in ORDERS[self.update][0])


_SHIFTS = dict(script="micro_shifts", ps=(8, 16), update="shifts")
_OPERANDS = dict(script="micro_operands", ps=(8,), rows_wrap=False, cols_wrap=False, update="center_first",
                 selects="nswe", out="edges", mask="inline")
_ORDER = dict(script="micro_order", ps=(8,), rows_wrap=False, cols_wrap=False, selects="nswe", out="edges",
              mask="inline")

#: Every variant, by name, in the order of ``csrc/micro_strip.cu``'s list
#: (``SS_MICRO_STRIP_VARIANTS``; a variant's id is its position).
VARIANTS = {
    # micro_shifts.py: how shifts and halo masks are lowered.
    "wrap": StripVariant(**_SHIFTS, rows_wrap=True, cols_wrap=True, selects="", out="edges", mask="none"),
    "hoisted": StripVariant(**_SHIFTS, rows_wrap=False, cols_wrap=False, selects="nswe", out="edges",
                            mask="hoisted"),
    "inline": StripVariant(**_SHIFTS, rows_wrap=False, cols_wrap=False, selects="nswe", out="edges",
                           mask="inline"),
    "concat": StripVariant(**_SHIFTS, rows_wrap=False, cols_wrap=False, selects="", out="edges", mask="frame"),
    "nomaskrow": StripVariant(**_SHIFTS, rows_wrap=True, cols_wrap=False, selects="we", out="edges",
                              mask="inline"),
    "composite": StripVariant(script="micro_shifts", ps=(8, 16), rows_wrap=True, cols_wrap=False,
                              update="composite", selects="x", out="edges", mask="inline"),
    "fma": StripVariant(script="micro_shifts", ps=(8, 16), rows_wrap=True, cols_wrap=True, update="fma",
                        selects="", out="edges", mask="none"),
    "shiftonly": StripVariant(script="micro_shifts", ps=(8, 16), rows_wrap=True, cols_wrap=True,
                              update="shift_only", selects="", out="edges", mask="none"),
    # Rows shrink by one a side a sub-step, so no row boundary is ever read:
    # the same values as a halo outside the window.
    "shrink": StripVariant(**_SHIFTS, rows_wrap=False, cols_wrap=False, selects="we", out="shrink",
                           mask="inline"),
    # micro_operands.py: scalars as operands instead of literals.
    "baseline": StripVariant(**_OPERANDS),
    "smem10": StripVariant(**_OPERANDS, n_extra=10),
    "coef": StripVariant(**_OPERANDS, coef_args=True),
    "hv": StripVariant(**_OPERANDS, hv_arg=True),
    "elemout": StripVariant(**_OPERANDS, row_pointer=True),
    "nowhere": StripVariant(**{**_OPERANDS, "out": "middle"}),
    "all": StripVariant(**_OPERANDS, n_extra=10, coef_args=True, hv_arg=True, row_pointer=True),
    # micro_order.py: accumulation orders (inter_cf rounds as centerfirst,
    # grouped_nwse as centerlast).
    "centerfirst": StripVariant(**_ORDER, update="center_first"),
    "centerlast": StripVariant(**_ORDER, update="center_last"),
    "inter_cf": StripVariant(**_ORDER, update="center_first"),
    "grouped_nwse": StripVariant(**_ORDER, update="center_last"),
}


@dataclasses.dataclass(frozen=True)
class StripScalars:
    """What the ``*_args`` variants read from kernel arguments (the TPU
    kernels' SMEM operands): micro_operands' values by default."""

    coefs: tuple = COEFS
    hv: float = 0.0
    extras: tuple = EXTRAS


def window_origin(i: int, H: int, T: int, hp: int) -> int:
    """First grid row of strip ``i``'s window."""
    return min(max(i * T - hp, 0), H - (T + 2 * hp))


def core_offset(variant: StripVariant, i: int, n_strips: int, hp: int, p: int) -> int:
    """Window row that becomes strip ``i``'s first row."""
    if variant.out == "shrink":
        return p
    if variant.out == "middle" or 0 < i < n_strips - 1:
        return hp
    return 0 if i == 0 else 2 * hp


def _check(x: torch.Tensor, name: str, T: int, hp: int, p: int) -> StripVariant:
    if name not in VARIANTS:
        raise ValueError(f"unknown strip variant {name!r}; the variants are {', '.join(VARIANTS)}")
    v = VARIANTS[name]
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"the strip pass takes a 2D float32 grid (got {x.dtype} {tuple(x.shape)})")
    H, _ = x.shape
    if T < 1 or hp < 0 or H % T or H < T + 2 * hp:
        raise ValueError(f"a {H}-row grid needs whole strips of T={T} rows and a window of T + 2*hp = "
                         f"{T + 2 * hp} rows at most")
    if v.update == "composite" and p % 2:
        raise ValueError("the composite variant runs p/2 two-step trips: p must be even")
    if v.out == "shrink" and hp != p:
        raise ValueError(f"the shrink variant's window shrinks to T rows only when hp == p (got hp={hp}, p={p})")
    return v


def _tap(y: torch.Tensor, dr: int, dc: int, rows_wrap: bool, cols_wrap: bool, hv: float) -> torch.Tensor:
    """``y[..., i + dr, j + dc]`` on windows ``y`` (..., rows, columns):
    around the torus of each axis that wraps, the halo value beyond each
    one that does not."""
    for d, dim, wrap in ((dr, -2, rows_wrap), (dc, -1, cols_wrap)):
        if not d:
            continue
        if wrap:
            y = torch.roll(y, -d, dims=dim)
            continue
        n = y.shape[dim]
        frame = torch.full_like(y.narrow(dim, 0, min(abs(d), n)), hv)
        y = torch.cat([y.narrow(dim, d, n - d), frame] if d > 0 else [frame, y.narrow(dim, 0, n + d)], dim)
    return y


def _weighted_sum(terms) -> torch.Tensor:
    """``sum(c * t)`` over ``terms`` of ``(tap, c, fused)``, left to right,
    contracting as the module docstring says."""
    (t0, c0, f0), (t1, c1, f1) = terms[:2]
    if f0:
        acc = fma_f32(t0, c0, t1 * c1)
    elif f1:
        acc = fma_f32(t1, c1, t0 * c0)
    else:
        acc = t0 * c0 + t1 * c1
    for t, c, f in terms[2:]:
        acc = fma_f32(t, c, acc) if f else acc + t * c
    return acc


def _substep(y: torch.Tensor, v: StripVariant, coefs, hv: float, extra_sum: float | None) -> torch.Tensor:
    """One sub-step (one two-step trip for the composite) of windows ``y``."""
    tap = lambda dr, dc: _tap(y, dr, dc, v.rows_wrap, v.cols_wrap, hv)  # noqa: E731
    if v.update == "fma":
        for a, b in FMA_TERMS:
            y = fma_f32(y, a, torch.full_like(y, b))
        return y
    if v.update == "shift_only":
        return (((tap(-1, 0) + tap(1, 0)) + tap(0, -1)) + tap(0, 1)) * SHIFT_ONLY_WEIGHT
    if v.update == "composite":
        fused = v.fused()
        return _weighted_sum([(tap(dy, dx), w, f) for (dy, dx, w), f in zip(COMPOSITE_TERMS, fused)])
    order, index = ORDERS[v.update]
    taps = {"x": y, "n": tap(-1, 0), "s": tap(1, 0), "w": tap(0, -1), "e": tap(0, 1)}
    out = _weighted_sum([(taps[t], coefs[k], f) for t, k, f in zip(order, index, v.fused())])
    if extra_sum is not None:
        out = out + 0.0 * extra_sum
    return out


def _shrink_substep(y: torch.Tensor, coefs, fused) -> torch.Tensor:
    """micro_shifts' ``shrink`` sub-step: one row fewer a side, columns
    outside the grid at 0."""
    center = y[..., 1:-1, :]
    taps = {"x": center, "n": y[..., :-2, :], "s": y[..., 2:, :],
            "w": _tap(center, 0, -1, False, False, 0.0), "e": _tap(center, 0, 1, False, False, 0.0)}
    order, index = ORDERS["shifts"]
    return _weighted_sum([(taps[t], coefs[k], f) for t, k, f in zip(order, index, fused)])


def _resolve(v: StripVariant, scalars: StripScalars | None):
    """(coefficients, halo value, sum of the extras or None) the variant
    computes with: literals unless it takes them as arguments."""
    s = scalars or StripScalars()
    coefs = tuple(float(np.float32(c)) for c in s.coefs) if v.coef_args else COEFS_F32
    hv = float(np.float32(s.hv)) if v.hv_arg else 0.0
    extra_sum = None
    if v.n_extra:
        if len(s.extras) < v.n_extra:
            raise ValueError(f"the variant takes {v.n_extra} extra scalars, got {len(s.extras)}")
        total = np.float32(0.0)
        for e in s.extras[: v.n_extra]:
            total = np.float32(total + np.float32(e))
        extra_sum = float(total)
    return coefs, hv, extra_sum


def strip_pass_plain(x: torch.Tensor, variant: str, *, T: int, hp: int, p: int,
                     scalars: StripScalars | None = None) -> torch.Tensor:
    """The plain PyTorch version of one pass: every window gathered, its
    ``p`` sub-steps on whole tensors, the cores written back."""
    v = _check(x, variant, T, hp, p)
    H, W = x.shape
    n_s, win = H // T, T + 2 * hp
    coefs, hv, extra_sum = _resolve(v, scalars)
    dev = x.device
    origins = torch.tensor([window_origin(i, H, T, hp) for i in range(n_s)], device=dev)
    y = x[origins[:, None] + torch.arange(win, device=dev)]  # (n_s, win, W)
    if v.out == "shrink":
        fused = v.fused()
        for _ in range(p):
            y = _shrink_substep(y, coefs, fused)
        return y.reshape(H, W)
    for _ in range(p // 2 if v.update == "composite" else p):
        y = _substep(y, v, coefs, hv, extra_sum)
    offsets = torch.tensor([core_offset(v, i, n_s, hp, p) for i in range(n_s)], device=dev)
    rows = offsets[:, None] + torch.arange(T, device=dev)
    return y[torch.arange(n_s, device=dev)[:, None], rows].reshape(H, W)


def variant_id(name: str) -> int:
    """A variant's position in ``csrc/micro_strip.cu``'s list."""
    return list(VARIANTS).index(name)


@torch.no_grad()
def strip_pass(x: torch.Tensor, variant: str, *, T: int, hp: int, p: int,
               scalars: StripScalars | None = None, out: torch.Tensor | None = None) -> torch.Tensor:
    """One pass of ``variant`` over the float32 grid ``x``: a new tensor,
    or ``out`` (of ``x``'s shape, not ``x``) written on the card. Raises
    for a geometry the variant does not take and, on the card, for a ``p``
    its kernel is not built for."""
    global launches
    v = _check(x, variant, T, hp, p)
    if x.device.type == "cpu":
        return strip_pass_plain(x, variant, T=T, hp=hp, p=p, scalars=scalars)
    if p not in v.ps:
        raise NotImplementedError(f"the strip kernel's {variant!r} is built for p in {v.ps}, not {p}")
    if not x.is_contiguous():
        raise ValueError("the strip pass takes a contiguous grid")
    H, W = x.shape
    if out is None:
        out = torch.empty_like(x)
    elif out.shape != x.shape or out.dtype != x.dtype or out.device != x.device or not out.is_contiguous() \
            or out.data_ptr() == x.data_ptr():
        raise ValueError("out must be a contiguous float32 grid of x's shape on its device, and not x")
    s = scalars or StripScalars()
    extras = list(s.extras[:10]) + [0.0] * (10 - len(s.extras[:10]))
    host = (ctypes.c_float * 16)(*[float(c) for c in s.coefs], float(s.hv), *extras)
    fn = entry("ss_micro_strip", "")
    with torch.cuda.device(x.device):
        code = fn(variant_id(variant), p, x.data_ptr(), out.data_ptr(), H, W, T, hp, host,
                  torch.cuda.current_stream(x.device).cuda_stream)
    check(code, f"strip kernel ({variant}, p={p})")
    launches += 1
    return out


def pass_bytes(H: int, W: int) -> int:
    """Bytes a pass must move: the grid read once and written once."""
    return 8 * H * W


def pass_operations(variant: str, H: int, W: int, p: int) -> int:
    """Float32 operations that one pass's output needs at least (a fused
    multiply-add counts as two): the ``H x W`` output cells' update at every
    sub-step (``p // 2`` trips of the two-step weights for composite). The
    halo rows a window recomputes are the kernel's choice, not counted."""
    v = VARIANTS[variant]
    per_cell = {"fma": 10, "shift_only": 4, "composite": 2 * len(COMPOSITE_TERMS) - 1}.get(v.update, 9)
    per_cell += 2 if v.n_extra else 0
    steps = p // 2 if v.update == "composite" else p
    return H * W * steps * per_cell
