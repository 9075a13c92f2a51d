"""Narrow storage dtypes (bfloat16, float8 e4m3fn) with float32 compute.

Counterpart of ``stencilstream_tpu/backends/storage_cast.py``. A grid whose
float32 fields are stored narrow moves half (bfloat16) or a quarter (float8)
of the bytes a pass moves in float32, and its windows take as much less
shared memory. Compute stays float32: every tap is upcast before the wrapped
transition function sees it, and the backends' ``canonicalize_cell`` rounds
each result back to the stored dtype as the JAX package rounds it
(:func:`..core.cell.to_storage`: float8 overflow is NaN, not saturated).

On the card the wrapper names its functor's narrow instantiation
(``cuda_storage``; ``csrc/common.cuh:Narrow``): the kernels hold the storage
type in device memory and in shared memory, convert each tap on read and
round each sub-step's output on store. Only the pairs of
:data:`.cuda_lib.NARROW_OPS` are built; another raises
``NotImplementedError`` on the card and runs on ``reference``.

Numerics: bfloat16 keeps float32's exponent range with 8 significant bits,
float8 e4m3 has 4 and a range of +-448; each stored sub-step rounds.

Usage::

    grid = cast_storage(grid)                 # float32 fields -> bfloat16
    tf = CastStorageKernel(inner_tf)          # taps arrive as float32
    update = create_update(Params(transition_function=tf, ...), backend="auto")
"""

from __future__ import annotations

from typing import Any

import torch

from ..core.cell import cell_leaves, cell_map, cell_unflatten, to_storage
from ..core.grid import Grid

__all__ = ["CastStorageKernel", "cast_storage"]


def cast_storage(grid_or_arrays: Any, storage_dtype: torch.dtype = torch.bfloat16, *,
                 from_dtype: torch.dtype = torch.float32) -> Any:
    """Cast every ``from_dtype`` field to ``storage_dtype`` (other fields,
    int and bool, are left alone). Takes a :class:`Grid` or a cell of
    tensors; the result stays on its device."""
    is_grid = isinstance(grid_or_arrays, Grid)
    arrays = grid_or_arrays.arrays if is_grid else grid_or_arrays
    out = cell_map(lambda a: to_storage(a, storage_dtype) if a.dtype == from_dtype else a, arrays)
    return Grid(out) if is_grid else out


class _CastStencil:
    """A narrow-storage stencil view in the compute dtype.

    Upcasts are memoised per offset, so a transition function that returns
    a tap unchanged (HotSpot's ``power``) returns the very tensor of the
    upcast centre, which :meth:`CastStorageKernel.__call__` replaces by the
    stored one."""

    __slots__ = ("_s", "_storage", "_compute", "_memo")

    def __init__(self, s: Any, storage: torch.dtype, compute: torch.dtype):
        self._s = s
        self._storage = storage
        self._compute = compute
        self._memo: dict = {}

    def __getitem__(self, key):
        key = (int(key[0]), int(key[1]))
        hit = self._memo.get(key)
        if hit is None:
            hit = cell_map(lambda a: a.to(self._compute) if a.dtype == self._storage else a, self._s[key])
            self._memo[key] = hit
        return hit

    def uid(self, ur: int, uc: int):
        r = self._s.radius
        return self[ur - r, uc - r]

    @property
    def center(self):
        return self[0, 0]

    @property
    def storage_dtype(self) -> torch.dtype:
        """The dtype the cells are stored in (a twin that must round as XLA
        does on such cells reads it: ``models/jacobi.py``)."""
        return self._storage

    def __getattr__(self, name):
        # radius, diameter, id, row, col, grid_range, iteration,
        # subiteration, time_dependent_value, tdv, on_boundary.
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._s, name)


class CastStorageKernel:
    """Wraps a transition function for narrow-storage grids: taps are upcast
    ``storage_dtype -> compute_dtype`` before ``tf`` sees them; the write
    rounds back (the backends' ``canonicalize_cell``). The contract (radius,
    sub-iterations, ``handles_boundary``, the time-dependent value) and the
    device functor's attributes (``cuda_op``, ``cuda_variant``,
    ``cuda_params``, ``cuda_tdv``, ``cuda_invariant_reads``,
    ``n_operations``, ...) are ``tf``'s; ``cuda_storage`` names the storage
    dtype."""

    def __init__(self, tf: Any, storage_dtype: torch.dtype = torch.bfloat16,
                 compute_dtype: torch.dtype = torch.float32):
        self.tf = tf
        self.cuda_storage = storage_dtype
        self.compute_dtype = compute_dtype

    @property
    def stencil_radius(self) -> int:
        return self.tf.stencil_radius

    @property
    def n_subiterations(self) -> int:
        return self.tf.n_subiterations

    @property
    def handles_boundary(self) -> bool:
        return getattr(self.tf, "handles_boundary", False)

    def get_time_dependent_value(self, i):
        return self.tf.get_time_dependent_value(i)

    def __getattr__(self, name):
        if name == "tf":  # not set yet (copy, unpickling)
            raise AttributeError(name)
        return getattr(self.tf, name)

    def __call__(self, s):
        cs = _CastStencil(s, self.cuda_storage, self.compute_dtype)
        out = self.tf(cs)
        # A field returned unchanged from the centre tap stays the stored
        # tensor, not its upcast (the JAX package keeps it loop-invariant so).
        out_leaves, up, raw = cell_leaves(out), cell_leaves(cs.center), cell_leaves(s[0, 0])
        if len(out_leaves) != len(up):
            return out
        return cell_unflatten(out, [r if o is u else o for o, u, r in zip(out_leaves, up, raw)])
