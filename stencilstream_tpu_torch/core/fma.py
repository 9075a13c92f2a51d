"""Fused multiply-adds in plain PyTorch, for float32 and float64.

XLA on the CPU fuses some multiply-adds of the JAX package's transition
functions, in float32 and in float64 alike, and the port's device functors
fuse the same ones with ``__fmaf_rn`` / ``__fma_rn``. Their torch twins need
the same rounding: ``a * b + c`` computed exactly and rounded once. Under
autograd they differentiate as ``a * b + c``.
"""

from __future__ import annotations

import torch

__all__ = ["fma", "fma_f32", "fma_f64"]


class _FusedMultiplyAdd(torch.autograd.Function):
    """An exact fused multiply-add whose backward is that of ``a * b + c``
    (the emulations' own graphs are not: where ``c`` dominates, float64's
    returns ``c`` itself, which would give ``a`` no gradient)."""

    @staticmethod
    def forward(ctx, a, b, c, exact):
        ctx.save_for_backward(a, b)
        ctx.c_shape = c.shape
        return exact(a, b, c)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        grads = [None] * 4
        if ctx.needs_input_grad[0]:
            grads[0] = (g * b).sum_to_size(a.shape)
        if ctx.needs_input_grad[1]:
            grads[1] = (g * a).sum_to_size(b.shape)
        if ctx.needs_input_grad[2]:
            grads[2] = g.sum_to_size(ctx.c_shape)
        return tuple(grads)


def _differentiable(exact):
    """``exact`` as it is, or through :class:`_FusedMultiplyAdd` where an
    operand requires grad."""

    def fused(a, b, c):
        operands = (a, b, c)
        if torch.is_grad_enabled() and any(isinstance(t, torch.Tensor) and t.requires_grad for t in operands):
            a, b, c = (torch.as_tensor(t, dtype=a.dtype, device=a.device) for t in operands)
            return _FusedMultiplyAdd.apply(a, b, c, exact)
        return exact(a, b, c)

    fused.__name__, fused.__qualname__, fused.__doc__ = exact.__name__, exact.__qualname__, exact.__doc__
    return fused


@_differentiable
def fma_f32(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to float32 (round to nearest even), for
    float32 tensors ``a``, ``c`` and a float32 tensor or float32-valued
    number ``b``.

    The product of two float32 values is exact in float64, and the float64
    sum ``s`` misses the exact sum by an error that TwoSum recovers exactly.
    Rounding ``s`` to float32 is then right unless ``s`` lies exactly
    halfway between two float32 values while the exact sum does not; the
    error's sign settles that tie.
    """
    p = a.double() * b
    c = c.double()
    s = p + c
    b_virtual = s - p
    err = (p - (s - b_virtual)) + (c - b_virtual)
    r = s.float()
    r64 = r.double()
    toward = torch.where(s > r64, torch.inf, -torch.inf).to(torch.float32)
    other = torch.nextafter(r, toward)
    other64 = other.double()
    tie = (s != r64) & ((r64 + other64) * 0.5 == s)
    wrong = tie & (err != 0) & ((err > 0) == (other64 > r64))
    return torch.where(wrong, other, r)


#: Veltkamp's splitting constant for float64: 2^27 + 1.
_SPLIT = 134217729.0


def _two_sum(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(s, e)`` with ``s = RN(a + b)`` and ``s + e = a + b`` exactly
    (Knuth's TwoSum; no condition on the operands' order)."""
    s = a + b
    b_virtual = s - a
    a_virtual = s - b_virtual
    return s, (a - a_virtual) + (b - b_virtual)


def _split(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Veltkamp's split: ``a = hi + lo`` exactly, each half of at most 26
    significant bits."""
    t = _SPLIT * a
    hi = t - (t - a)
    return hi, a - hi


def _two_product(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(p, e)`` with ``p = RN(a * b)`` and ``p + e = a * b`` exactly
    (Dekker's product, with no fused multiply-add)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


#: Operands and products below these magnitudes are scaled up by
#: 2^_SCALE before the emulation, so that no partial product underflows.
_TINY_OPERAND = 2.0**-400
_TINY_PRODUCT = 2.0**-900
_SCALE = 600


def _emulated(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Boldo and Melquiond's emulation: ``(w, sign)``, ``w = RN(a*b + c)``
    and the sign of ``a*b + c - w`` (-1, 0 or 1), where no step underflows."""
    uh, ul = _two_product(a, b)
    th, tl = _two_sum(c, uh)
    s, e = _two_sum(tl, ul)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(e > 0, torch.inf, -torch.inf).to(torch.float64)
    v = torch.where((e != 0) & even, torch.nextafter(s, toward), s)  # RO(tl + ul)
    w, e1 = _two_sum(th, v)
    # The exact sum is th + tl + ul = w + e1 + (tl + ul - v); a non-zero e1
    # is at least an ulp of v, more than |tl + ul - v|.
    low = torch.where(v != s, -torch.sign(e), torch.sign(e))
    return w, torch.where(e1 != 0, torch.sign(e1), low)


def _scaled(x: torch.Tensor, k: torch.Tensor, sign: int) -> torch.Tensor:
    """``x * 2^(sign * _SCALE)`` where ``k`` is set, ``x`` elsewhere."""
    return torch.where(k, x * 2.0 ** (sign * _SCALE), x)


@_differentiable
def fma_f64(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to float64 (round to nearest even), for
    float64 tensors ``a``, ``c`` and a float64 tensor or number ``b``.

    No PyTorch call fuses a float64 multiply-add on the CPU, and float64
    cannot hold a float64 product exactly, so this is Boldo and Melquiond's
    emulation ("Emulation of FMA and correctly rounded sums: proved
    algorithms using rounding to odd", IEEE Trans. Computers 57(4), 2008),
    in float64 arithmetic alone:

    * ``(uh, ul) = TwoProduct(a, b)``, with Veltkamp's split;
    * ``(th, tl) = TwoSum(c, uh)``;
    * ``v = RO(tl + ul)``, the sum rounded to odd: TwoSum, then one ulp
      toward the error when the error is non-zero and the sum's last
      significand bit is even;
    * the result is ``RN(th + v)``.

    That is exact, ties and cancellation (``c = -a*b``) included, wherever
    no step underflows or overflows. Small operands are handled so that none
    underflows, down to subnormal ones and subnormal results:

    * where ``|c|`` is at least 2^60 times ``|a*b|`` (or 2^-1074), the
      result is ``c`` (the product is below a 32nd of an ulp of ``c``);
    * else, where ``|a*b|`` is below 2^-900, each operand below 2^-400 is
      scaled by 2^600 and ``c`` with them, the emulation runs on the scaled
      operands, and its result is scaled back; a result that is subnormal
      then rounds twice, and where the first rounding left it exactly
      halfway between two subnormals, the sign of the emulation's error
      picks the right one.

    It overflows where ``|a|`` or ``|b|`` exceeds about 2^996 (the split
    multiplies by 2^27 + 1), or ``|a*b|`` or ``|c|`` about 2^1021. Where
    ``a * b + c`` evaluated directly is not finite, that value is returned
    (an infinite or NaN operand, or an overflow), and so is its zero where
    the result is zero.
    """
    a = torch.as_tensor(a, dtype=torch.float64)
    b = torch.as_tensor(b, dtype=torch.float64, device=a.device)
    c = torch.as_tensor(c, dtype=torch.float64, device=a.device)
    a, b, c = torch.broadcast_tensors(a, b, c)
    direct = a * b + c
    p = (a * b).abs()
    tiny = p < _TINY_PRODUCT
    ka = tiny & (a.abs() < _TINY_OPERAND)
    kb = tiny & (b.abs() < _TINY_OPERAND)
    w, err_sign = _emulated(_scaled(a, ka, 1), _scaled(b, kb, 1), _scaled(_scaled(c, ka, 1), kb, 1))
    r = _scaled(_scaled(w, kb, -1), ka, -1)
    # A subnormal r rounded twice: where w lay exactly halfway between two
    # subnormals (scaled), the exact sum beyond w belongs to the other one.
    back = _scaled(_scaled(r, ka, 1), kb, 1)
    half = torch.full_like(w, torch.inf)
    half = torch.where(ka | kb, 2.0 ** (_SCALE - 1075), half)
    half = torch.where(ka & kb, 2.0 ** (2 * _SCALE - 1075), half)
    tie = (w - back).abs() == half
    other = torch.nextafter(r, torch.where(w > back, torch.inf, -torch.inf).to(torch.float64))
    r = torch.where(tie & (err_sign != 0) & (err_sign == torch.sign(w - back)), other, r)
    r = torch.where(c.abs() >= 2.0**60 * torch.clamp(p, min=2.0**-1074), c, r)
    return torch.where(torch.isfinite(direct) & torch.isfinite(r) & (r != 0), r, direct)


def fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to ``a``'s dtype: :func:`fma_f32` for
    float32, :func:`fma_f64` for float64."""
    if a.dtype == torch.float64:
        return fma_f64(a, b, c)
    if a.dtype == torch.float32:
        return fma_f32(a, b, c)
    raise TypeError(f"fma takes float32 or float64 tensors, got {a.dtype}")
