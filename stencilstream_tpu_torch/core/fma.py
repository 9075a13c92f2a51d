"""A float32 fused multiply-add in plain PyTorch.

XLA on the CPU fuses some multiply-adds of the JAX package's transition
functions, and the port's device functors fuse the same ones with
``__fmaf_rn``. Their torch twins need the same rounding: ``a * b + c``
computed exactly and rounded once to float32.
"""

from __future__ import annotations

import torch

__all__ = ["fma_f32"]


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
