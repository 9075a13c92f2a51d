"""Stencil update backends.

* ``reference`` — plain PyTorch oracle; runs on any device.
* ``monotile`` — the whole grid resident in the CTAs' shared memory, all
  iterations of a call in one cooperative CUDA launch.
* ``tiling`` — temporal blocking over 2D tiles, one CUDA launch per pass of
  p fused iterations; any grid size.
* ``distributed`` — the grid sharded over a 2D mesh of devices, halos
  exchanged every pass, the tile pass in extended mode on each shard.
* ``ring`` — a temporal pipeline of row chunks over a ring of devices.
* ``auto`` — ``distributed`` when more than one device is visible and the
  grid is large enough, else ``monotile`` when the grid fits its capacity
  law, else ``tiling``.

On CPU tensors ``monotile`` and ``tiling`` run their kernels' plain PyTorch
versions; ``distributed`` and ``ring`` run on a mesh of CUDA devices, or of
CPU devices when given one.
"""

from . import reference

__all__ = ["reference", "create_update", "available_backends"]

_REGISTRY = {}


def register_backend(name, factory):
    _REGISTRY[name] = factory


def available_backends():
    return sorted(_REGISTRY)


def create_update(params, backend: str = "auto", **backend_kwargs):
    """Construct a StencilUpdate for the named backend."""
    try:
        factory = _REGISTRY[backend]
    except KeyError:
        raise ValueError(
            f"unknown backend {backend!r}; available: {available_backends()}"
        ) from None
    return factory(params, **backend_kwargs)


def _make_monotile(params, **kw):
    from . import monotile

    return monotile.StencilUpdate(params, **kw)


def _make_tiling(params, **kw):
    from . import tiling

    return tiling.StencilUpdate(params, **kw)


def _make_distributed(params, **kw):
    from . import distributed

    return distributed.StencilUpdate(params, **kw)


def _make_ring(params, **kw):
    from . import ring

    return ring.StencilUpdate(params, **kw)


def _make_auto(params, **kw):
    from . import auto

    return auto.StencilUpdate(params, **kw)


register_backend("auto", _make_auto)
register_backend("reference", lambda params, **kw: reference.StencilUpdate(params))
register_backend("monotile", _make_monotile)
register_backend("tiling", _make_tiling)
register_backend("distributed", _make_distributed)
register_backend("ring", _make_ring)
