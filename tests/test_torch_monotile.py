"""The resident-grid kernel's plain version and the monotile backend of the
PyTorch/CUDA port against the JAX package's monotile backend, run in Pallas
interpret mode on the CPU; and the port's capacity law.

The kernels themselves are tested on the card by tests/test_torch_kernels.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencilstream_tpu.backends import create_update as j_create_update
from stencilstream_tpu.core import Grid as JGrid
from stencilstream_tpu.core import Params as JParams
from stencilstream_tpu.models import hotspot as jhs

from stencilstream_tpu_torch import Grid, Params, create_update, interop
from stencilstream_tpu_torch.backends.cuda_lib import H100_SXM, DeviceLimits
from stencilstream_tpu_torch.backends.monotile import monotile_plan
from stencilstream_tpu_torch.models import hotspot as hs

STRONG = dict(Rx_1=np.float32(0.1), Ry_1=np.float32(0.1), Rz_1=np.float32(0.05), Cap_1=np.float32(0.5))


def _np_cell(shape, seed=0):
    rng = np.random.default_rng(seed)
    return jhs.HotspotCell(
        temp=rng.uniform(70, 90, shape).astype(np.float32),
        power=rng.uniform(0, 1e-3, shape).astype(np.float32),
    )


@pytest.mark.parametrize("coeffs", ["derived", "strong"])
@pytest.mark.parametrize("shape", [(16, 24), (40, 72)], ids=["16x24", "40x72"])
def test_monotile_matches_jax_monotile(shape, coeffs):
    """n=5 from iteration_offset=3, halo 0: the port's monotile on the CPU
    against JAX monotile (interpret mode), rtol 1e-6, atol 1e-5."""
    jkernel = jhs.derive_coefficients(*shape) if coeffs == "derived" else jhs.HotspotKernel(**STRONG)
    np_cell = _np_cell(shape, 1)
    j_out = j_create_update(
        JParams(
            transition_function=jkernel,
            halo_value=jhs.HotspotCell(temp=jnp.float32(0), power=jnp.float32(0)),
            iteration_offset=3,
            n_iterations=5,
        ),
        backend="monotile",
    )(JGrid.from_numpy(np_cell)).to_numpy()
    out = create_update(
        Params(
            transition_function=interop.hotspot_kernel(dataclasses.asdict(jkernel)),
            halo_value=hs.HotspotCell(temp=0.0, power=0.0),
            iteration_offset=3,
            n_iterations=5,
        ),
        backend="monotile",
    )(interop.hotspot_grid(np_cell, device="cpu")).to_numpy()
    np.testing.assert_allclose(out.temp, j_out.temp, rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(out.power, j_out.power)


def test_monotile_zero_iterations_returns_the_grid():
    grid = interop.hotspot_grid(_np_cell((8, 8)), device="cpu")
    out = create_update(Params(hs.HotspotKernel(**STRONG), n_iterations=0), backend="monotile")(grid)
    np.testing.assert_array_equal(out.to_numpy().temp, grid.to_numpy().temp)


def test_capacity_law():
    """One CTA per SM, a band of ceil(H / SMs) rows plus r halo rows above
    and below, (W + 2r) columns, 12 B per HotSpot cell (two temp planes,
    one power plane)."""
    plan = monotile_plan(1024, 1024, 1, 12, H100_SXM)
    assert plan.band == 8 and plan.n_ctas == 128 and plan.smem_bytes == 10 * 1026 * 12
    assert monotile_plan(37, 53, 1, 12, H100_SXM).band == 1
    assert monotile_plan(5, 53, 2, 12, H100_SXM).band == 2  # never below r
    assert monotile_plan(8192, 8192, 1, 12, H100_SXM) is None
    assert monotile_plan(2048, 2048, 1, 12, H100_SXM) is None
    assert monotile_plan(1024, 1024, 1, 12, DeviceLimits(132, 100 * 1024)) is None
    assert monotile_plan(1024, 1024, 1, 12, DeviceLimits(66, 232448)).band == 16


def test_capacity_error_points_at_tiling():
    z = torch.zeros(1, 1).expand(8192, 8192)
    grid = Grid(hs.HotspotCell(temp=z, power=z))
    update = create_update(Params(hs.HotspotKernel(), n_iterations=1), backend="monotile")
    with pytest.raises(ValueError, match="tiling"):
        update(grid)
