"""The self-verifying probe on every backend of the PyTorch/CUDA port.

The probe cell checks the execution contract from inside the update: halo
handling, iteration and sub-iteration counting, the time-dependent value and
each cell's position (``stencilstream_tpu_torch/probe.py``, the counterpart
of tests/probe.py). Every case runs the same grid through the JAX package's
``reference`` backend and holds the port to it exactly: the probe is integer
bookkeeping, so there is no rounding to allow for.
"""

import numpy as np
import pytest

from stencilstream_tpu.backends import create_update as j_create_update
from stencilstream_tpu.core import Params as JParams

from probe import ProbeTransFunc as JProbe
from probe import make_probe_grid as j_make_probe_grid
from probe import probe_halo_cell as j_probe_halo

from stencilstream_tpu_torch import Params, create_update, probe

FIELDS = ("r", "c", "i_iteration", "i_subiteration", "status")

#: (backend, options): both tiling modes with passes that end partial.
BACKENDS = [
    ("reference", {}),
    ("tiling", dict(iters_per_pass=2)),
    ("tiling", dict(iters_per_pass=2, window_mode="linecache", strip_rows=4)),
    ("monotile", {}),
    ("auto", {}),
]
BACKEND_IDS = ["reference", "tiling", "tiling-linecache", "monotile", "auto"]


def _jax_reference(shape, offset, n, tdv="inline"):
    params = JParams(
        transition_function=JProbe(), halo_value=j_probe_halo(),
        iteration_offset=offset, n_iterations=n, tdv_strategy=tdv,
    )
    return j_create_update(params, backend="reference")(j_make_probe_grid(*shape, offset)).to_numpy()


def _port(tf, backend, kw, shape, offset, n, tdv="inline"):
    params = Params(
        tf, halo_value=probe.probe_halo_cell(), iteration_offset=offset, n_iterations=n,
        tdv_strategy=tdv,
    )
    update = create_update(params, backend=backend, **kw)
    return update(probe.make_probe_grid(*shape, offset, device="cpu")), update


def _assert_equal(got, want):
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)


@pytest.mark.parametrize("tdv", ["inline", "precompute_on_host", "precompute_on_device"])
@pytest.mark.parametrize("backend,kw", BACKENDS, ids=BACKEND_IDS)
def test_probe_contract_on_every_backend(backend, kw, tdv):
    """12x11 from iteration offset 2, n=3: every cell Normal at iteration
    5, equal to JAX's reference."""
    out, _ = _port(probe.ProbeTransFunc(), backend, kw, (12, 11), 2, 3, tdv)
    probe.check_probe_grid(out, 5)
    _assert_equal(out.to_numpy(), _jax_reference((12, 11), 2, 3, tdv))


@pytest.mark.parametrize("backend,kw", BACKENDS, ids=BACKEND_IDS)
@pytest.mark.parametrize("shape,offset,n", [((13, 21), 1, 5), ((9, 30), 0, 1), ((28, 11), 4, 0)])
def test_probe_without_tdv_on_every_backend(backend, kw, shape, offset, n):
    """ProbeKernel, the variant the CUDA kernels run: the same cells as the
    JAX probe after the same iterations, zero iterations included."""
    out, _ = _port(probe.ProbeKernel(), backend, kw, shape, offset, n)
    probe.check_probe_grid(out, offset + n)
    _assert_equal(out.to_numpy(), _jax_reference(shape, offset, n))


@pytest.mark.parametrize("backend,kw", BACKENDS[:4], ids=BACKEND_IDS[:4])
def test_probe_flags_a_wrong_iteration(backend, kw):
    """Cells at iteration 3 run from iteration_offset 2: the counters
    disagree with the update's own iteration, so every cell turns Invalid."""
    params = Params(
        probe.ProbeKernel(), halo_value=probe.probe_halo_cell(), iteration_offset=2, n_iterations=2
    )
    out = create_update(params, backend=backend, **kw)(probe.make_probe_grid(10, 12, 3, device="cpu"))
    assert (out.to_numpy().status == probe.INVALID).all()
    with pytest.raises(AssertionError, match="Invalid"):
        probe.check_probe_grid(out, 4)


def test_probe_flags_a_wrong_halo():
    """A halo cell that is not the probe's own makes the edge cells Invalid
    at the first sub-step and their neighbours at the second; the interior
    stays Normal."""
    halo = probe.ProbeCell(r=0, c=0, i_iteration=0, i_subiteration=0, status=probe.NORMAL)
    params = Params(probe.ProbeKernel(), halo_value=halo, n_iterations=1)
    status = create_update(params, backend="tiling")(probe.make_probe_grid(8, 9, device="cpu"))
    status = status.to_numpy().status
    assert (status[2:-2, 2:-2] == probe.NORMAL).all()
    edge = np.ones_like(status, bool)
    edge[2:-2, 2:-2] = False
    assert (status[edge] == probe.INVALID).all()


def test_resume_equivalence():
    """n=5 in one call equals 2 + 3 split with iteration_offset, through the
    line-cache mode."""
    kw = dict(iters_per_pass=2, window_mode="linecache", strip_rows=4)
    one, _ = _port(probe.ProbeKernel(), "tiling", kw, (14, 17), 0, 5)
    params = Params(probe.ProbeKernel(), halo_value=probe.probe_halo_cell(), iteration_offset=2, n_iterations=3)
    first, _ = _port(probe.ProbeKernel(), "tiling", kw, (14, 17), 0, 2)
    split = create_update(params, backend="tiling", **kw)(first)
    _assert_equal(one.to_numpy(), split.to_numpy())
    probe.check_probe_grid(split, 5)
