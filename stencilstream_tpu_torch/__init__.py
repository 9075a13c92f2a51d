"""stencilstream_tpu_torch — the PyTorch/CUDA port of stencilstream_tpu.

The same contract as the JAX package: a user writes a *transition function*
mapping a halo-padded neighborhood view (:class:`Stencil`) of each cell to
the cell's next value, and the framework applies it over a 2D grid for N
iterations on one of several backends (plain PyTorch ``reference`` oracle,
shared-memory-resident ``monotile``, tiled ``tiling``, and ``auto``).

On the card, ``monotile`` and ``tiling`` run hand-written CUDA C++ kernels
(``csrc/``) templated on a device functor that the transition function
names; on CPU tensors they run the kernels' plain PyTorch versions. This
package imports ``torch`` and numpy, never JAX.
"""

from .core import (
    BaseTransitionFunction,
    BlockGrid,
    Grid,
    Params,
    Stencil,
    cell_type,
    static_field,
    transition_function,
)
from .tdv import (
    InlineTDV,
    PrecomputeOnDeviceTDV,
    PrecomputeOnHostTDV,
    TDVStrategy,
)
from .backends import available_backends, create_update, reference

__version__ = "0.1.0"

__all__ = [
    "BaseTransitionFunction",
    "BlockGrid",
    "Grid",
    "InlineTDV",
    "Params",
    "PrecomputeOnDeviceTDV",
    "PrecomputeOnHostTDV",
    "Stencil",
    "TDVStrategy",
    "available_backends",
    "cell_type",
    "create_update",
    "reference",
    "static_field",
    "transition_function",
]
