"""Jacobi — eight kernel variants scaling arithmetic intensity from 1 to 17
FLOPs/cell, on the PyTorch/CUDA port.

Counterpart of ``stencilstream_tpu/models/jacobi.py``: the variants, a
block-initialized one-field float32 grid (the centered half-size rectangle
at 1.0), a raw-float32 output dump and a ``show-config`` JSON mode.

Each variant is both the plain PyTorch transition function and the name of
its device functor (``csrc/ops/jacobi.cuh``). Both keep the association
with which XLA on the CPU evaluates the JAX package's variant, including
the multiply-adds it fuses, so the port matches the JAX oracle bit for bit:
a fused step is ``__fmaf_rn(tap, coef, acc)`` in the functor and
:func:`~stencilstream_tpu_torch.core.fma.fma_f32` in the twin.

Run it on the card::

    python -m stencilstream_tpu_torch.models.jacobi 8192 8192 200 out.bin 0.15 0.2 0.25 0.1 0.3
    python -m stencilstream_tpu_torch.models.jacobi show-config jacobi5_general
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..backends import create_update
from ..core import Grid, Params, transition_function
from ..core.fma import fma_f32 as fma
from ..utils.io import write_float_grid_binary

__all__ = ["VARIANTS", "make_kernel", "init_grid", "run", "main"]

f32 = np.float32


def _f32(value):
    """A coefficient rounded to float32: a Python float (exact) for a
    number; for a tensor, a float32 tensor, which keeps its autograd graph
    (the ``reference`` backend differentiates through it)."""
    if isinstance(value, torch.Tensor):
        return value.to(torch.float32)
    return float(f32(value))


class _Jacobi:
    """What the variants share: radius 1, no sub-steps, no TDV, one field
    updated by the functor named after the variant."""

    stencil_radius = 1
    n_subiterations = 1
    cuda_variant = ()

    def cuda_params(self) -> tuple[float, ...]:
        return ()

    def get_time_dependent_value(self, i):
        return None


@transition_function
class Jacobi1General(_Jacobi):
    """1 op/cell: ``coef * center``."""

    cuda_op = "jacobi1_general"
    n_operations = 1
    n_coefficients = 1
    coef: float = 1.0

    def cuda_params(self):
        return (_f32(self.coef),)

    def __call__(self, s):
        return s[0, 0] * _f32(self.coef)


@transition_function
class Jacobi2Constant(_Jacobi):
    """2 ops/cell."""

    cuda_op = "jacobi2_constant"
    n_operations = 2
    n_coefficients = 0

    def __call__(self, s):
        return (s[-1, 0] + s[1, 0]) * 0.5


@transition_function
class Jacobi3Constant(_Jacobi):
    """3 ops/cell, center tap first (the JAX package's order)."""

    cuda_op = "jacobi3_constant"
    n_operations = 3
    n_coefficients = 0

    def __call__(self, s):
        return (s[0, 0] + s[-1, 0] + s[1, 0]) * float(f32(0.33333334))


@transition_function
class Jacobi4Constant(_Jacobi):
    """4 ops/cell, 4-point cross."""

    cuda_op = "jacobi4_constant"
    n_operations = 4
    n_coefficients = 0

    def __call__(self, s):
        return (s[-1, 0] + s[0, -1] + s[1, 0] + s[0, 1]) * 0.25


@transition_function
class Jacobi5Constant(_Jacobi):
    """5 ops/cell, 5-point star, center tap first."""

    cuda_op = "jacobi5_constant"
    n_operations = 5
    n_coefficients = 0

    def __call__(self, s):
        return (s[0, 0] + s[-1, 0] + s[0, -1] + s[1, 0] + s[0, 1]) * float(f32(0.2))


@transition_function
class Jacobi4General(_Jacobi):
    """7 ops/cell, 4 coefficients."""

    cuda_op = "jacobi4_general"
    n_operations = 7
    n_coefficients = 4
    c0: float = 0.25
    c1: float = 0.25
    c2: float = 0.25
    c3: float = 0.25

    def cuda_params(self):
        return tuple(_f32(c) for c in (self.c0, self.c1, self.c2, self.c3))

    def __call__(self, s):
        c0, c1, c2, c3 = self.cuda_params()
        acc = fma(s[-1, 0], c0, s[0, -1] * c1)
        acc = fma(s[1, 0], c2, acc)
        return fma(s[0, 1], c3, acc)


@transition_function
class Jacobi5General(_Jacobi):
    """9 ops/cell, 5 coefficients: the headline benchmark variant. The
    accumulation starts with the center term (the JAX package's order)."""

    cuda_op = "jacobi5_general"
    n_operations = 9
    n_coefficients = 5
    c0: float = 0.2
    c1: float = 0.2
    c2: float = 0.2
    c3: float = 0.2
    c4: float = 0.2

    def cuda_params(self):
        return tuple(_f32(c) for c in (self.c0, self.c1, self.c2, self.c3, self.c4))

    def __call__(self, s):
        c0, c1, c2, c3, c4 = self.cuda_params()
        acc = s[0, 0] * c4
        acc = fma(s[-1, 0], c0, acc)
        if getattr(s, "storage_dtype", None) == torch.bfloat16:
            # On bfloat16 cells (backends/storage_cast.py) XLA leaves this
            # multiply-add unfused.
            acc = acc + s[0, -1] * c1
        else:
            acc = fma(s[0, -1], c1, acc)
        acc = fma(s[1, 0], c2, acc)
        return fma(s[0, 1], c3, acc)


@transition_function
class Jacobi9General(_Jacobi):
    """17 ops/cell, full 3x3 coefficient matrix (row-major), center first."""

    cuda_op = "jacobi9_general"
    n_operations = 17
    n_coefficients = 9
    coef: tuple = (0.111111,) * 9

    def cuda_params(self):
        return tuple(_f32(c) for c in self.coef)

    def __call__(self, s):
        coef = self.cuda_params()
        acc = s[0, 0] * coef[4]
        for dr in (-1, 0, 1):
            for dc in (-1, 0, 1):
                if (dr, dc) != (0, 0):
                    acc = fma(s[dr, dc], coef[(dr + 1) * 3 + dc + 1], acc)
        return acc


VARIANTS = {
    "jacobi1_general": Jacobi1General,
    "jacobi2_constant": Jacobi2Constant,
    "jacobi3_constant": Jacobi3Constant,
    "jacobi4_constant": Jacobi4Constant,
    "jacobi5_constant": Jacobi5Constant,
    "jacobi4_general": Jacobi4General,
    "jacobi5_general": Jacobi5General,
    "jacobi9_general": Jacobi9General,
}


def make_kernel(variant: str, coefs=()):
    cls = VARIANTS[variant]
    n = cls.n_coefficients
    coefs = [float(c) for c in coefs]
    if len(coefs) != n:
        raise ValueError(f"{variant} takes {n} coefficient(s), got {len(coefs)}")
    if n == 0:
        return cls()
    if cls is Jacobi1General:
        return cls(coef=coefs[0])
    if cls is Jacobi9General:
        return cls(coef=tuple(coefs))
    return cls(**{f"c{i}": c for i, c in enumerate(coefs)})


def init_grid(height: int, width: int, *, device="cuda") -> Grid:
    """Block initialization: 1.0 inside the centered half-size rectangle,
    0.0 elsewhere; on the card unless ``device`` says otherwise."""
    r = np.arange(height)[:, None]
    c = np.arange(width)[None, :]
    block = (
        (r >= height * 0.25) & (r < height * 0.75) & (c >= width * 0.25) & (c < width * 0.75)
    )
    return Grid.from_numpy(block.astype(np.float32), device=device)


def run(grid: Grid, kernel, n_iterations: int, backend: str = "auto", **backend_kwargs):
    """``n_iterations`` of ``kernel`` on ``grid`` with halo 0.0; returns
    ``(grid, update)``."""
    update = create_update(
        Params(transition_function=kernel, halo_value=0.0, n_iterations=n_iterations, blocking=True),
        backend=backend,
        **backend_kwargs,
    )
    return update(grid), update


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "show-config":
        variant = argv[1] if len(argv) > 1 else "jacobi5_general"
        cls = VARIANTS[variant]
        print(
            json.dumps(
                {
                    "variant": variant,
                    "n_coefficients": cls.n_coefficients,
                    "n_operations": cls.n_operations,
                },
                indent=4,
            )
        )
        return 0

    parser = argparse.ArgumentParser(prog="jacobi")
    parser.add_argument("grid_rows", type=int)
    parser.add_argument("grid_cols", type=int)
    parser.add_argument("n_iterations", type=int)
    parser.add_argument("output_file")
    parser.add_argument("coefs", nargs="*", type=float)
    parser.add_argument("--variant", default="jacobi5_general", choices=sorted(VARIANTS))
    parser.add_argument("--backend", default="auto")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)

    kernel = make_kernel(args.variant, args.coefs)
    grid = init_grid(args.grid_rows, args.grid_cols, device=torch.device(args.device))
    print("Starting simulation")
    out, update = run(grid, kernel, args.n_iterations, backend=args.backend)
    print("Simulation complete!")
    print(f"Walltime: {update.get_walltime()} s")
    write_float_grid_binary(args.output_file, out.to_numpy())
    return 0


if __name__ == "__main__":
    sys.exit(main())
