"""Update parameters — the runtime configuration surface.

Counterpart of ``stencilstream_tpu/core/params.py``, with the same fields:
the transition-function instance, the halo value, the iteration offset
(pause/resume), the iteration count, blocking, and the TDV strategy.

``get_params()``-style mutation is supported: every field is read at call
time, and a transition function's numeric fields reach the CUDA kernels as
scalar launch arguments, so mutating them between calls rebuilds nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["Params"]


@dataclasses.dataclass
class Params:
    #: The transition function instance; runtime parameters live on it.
    transition_function: Any

    #: Cell value presented for neighbors outside the grid. ``None`` means
    #: a zero cell of the grid's dtypes.
    halo_value: Any = None

    #: Added to the step index so a resumed simulation sees consistent
    #: ``stencil.iteration`` and TDV values.
    iteration_offset: int = 0

    #: Number of logical iterations per call (each runs ``n_subiterations``
    #: sub-steps).
    n_iterations: int = 1

    #: Wait for the device to finish before returning (for meaningful
    #: walltime measurements).
    blocking: bool = False

    #: TDV strategy: "inline", "precompute_on_device", "precompute_on_host",
    #: or a :class:`stencilstream_tpu_torch.tdv.TDVStrategy` instance.
    tdv_strategy: Any = "inline"
