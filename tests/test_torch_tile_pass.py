"""The tile-pass kernel's plain version and the tiling backend of the
PyTorch/CUDA port against the JAX package's tiling backend, run in Pallas
interpret mode on the CPU as tests/test_apps_on_backends.py runs it.

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

from stencilstream_tpu_torch import Params, create_update, interop
from stencilstream_tpu_torch.backends.cuda_lib import H100_SXM, DeviceLimits
from stencilstream_tpu_torch.backends.tile_pass import tile_pass
from stencilstream_tpu_torch.backends.tiling import pick_config
from stencilstream_tpu_torch.models import hotspot as hs

#: Strong coefficients: each iteration moves temperatures by ~1e-1, so a
#: missing or extra step cannot hide under the tolerance.
STRONG = dict(Rx_1=np.float32(0.1), Ry_1=np.float32(0.1), Rz_1=np.float32(0.05), Cap_1=np.float32(0.5))


def _kernels(shape):
    return {
        "derived": jhs.derive_coefficients(*shape),
        "strong": jhs.HotspotKernel(**STRONG),
    }


def _np_cell(shape, seed=0):
    rng = np.random.default_rng(seed)
    return jhs.HotspotCell(
        temp=rng.uniform(70, 90, shape).astype(np.float32),
        power=rng.uniform(0, 1e-3, shape).astype(np.float32),
    )


@pytest.mark.parametrize("coeffs", ["derived", "strong"])
@pytest.mark.parametrize("shape", [(16, 24), (40, 72)], ids=["16x24", "40x72"])
def test_tiling_matches_jax_tiling(shape, coeffs):
    """n=5 from iteration_offset=3 at p=2 (the third pass is partial), halo
    value 0: the port's tiling on the CPU against JAX tiling (strip_rows=8,
    iters_per_pass=2, interpret mode), rtol 1e-6, atol 1e-5."""
    jkernel = _kernels(shape)[coeffs]
    np_cell = _np_cell(shape)
    j_params = JParams(
        transition_function=jkernel,
        halo_value=jhs.HotspotCell(temp=jnp.float32(0), power=jnp.float32(0)),
        iteration_offset=3,
        n_iterations=5,
    )
    j_out = j_create_update(j_params, backend="tiling", strip_rows=8, iters_per_pass=2)(
        JGrid.from_numpy(np_cell)
    ).to_numpy()
    update = create_update(
        Params(
            transition_function=interop.hotspot_kernel(dataclasses.asdict(jkernel)),
            halo_value=hs.HotspotCell(temp=0.0, power=0.0),
            iteration_offset=3,
            n_iterations=5,
        ),
        backend="tiling",
        iters_per_pass=2,
    )
    out = update(interop.hotspot_grid(np_cell, device="cpu")).to_numpy()
    assert update.resolved_config["iters_per_pass"] == 2
    np.testing.assert_allclose(out.temp, j_out.temp, rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(out.power, j_out.power)


@pytest.mark.parametrize("i_start,active", [(3, 2), (5, 1), (6, 0)])
def test_tile_pass_plain_is_a_partial_pass(i_start, active):
    """One pass of p=2 from ``i_start`` with offset 3 and n=3 runs exactly
    the steps before iteration 6 (exact in float32)."""
    kernel = hs.HotspotKernel(**STRONG)
    halo = hs.HotspotCell(temp=0.0, power=0.0)
    cell = interop.hotspot_grid(_np_cell((9, 11), 4), device="cpu").arrays
    out = tile_pass(cell, kernel, halo, i_start=i_start, offset=3, n_iterations=3, iters_per_pass=2)
    want = create_update(
        Params(kernel, halo_value=halo, iteration_offset=i_start, n_iterations=active),
        backend="reference",
    )(interop.hotspot_grid(_np_cell((9, 11), 4), device="cpu"))
    np.testing.assert_array_equal(out.temp.numpy(), want.arrays.temp.numpy())


def test_pick_config_reads_the_device():
    """64x64 tiles and the largest p with a halo within an eighth of the
    core, shrunk until the window fits half the shared memory."""
    assert pick_config(8192, 8192, 1, 1, 1000, 12, H100_SXM) == (64, 64, 8)
    assert pick_config(20, 24, 1, 1, 1000, 12, H100_SXM) == (24, 32, 3)
    assert pick_config(8192, 8192, 1, 1, 5, 12, H100_SXM)[2] == 5
    small = DeviceLimits(sm_count=4, smem_per_block=48 * 1024)
    th, tw, p = pick_config(8192, 8192, 1, 1, 1000, 12, small)
    assert (th + 2 * p) * (tw + 2 * p) * 12 <= small.smem_per_block // 2
    assert pick_config(8192, 8192, 1, 1, 1000, 12, small, iters_per_pass=8) == (16, 32, 8)
    tiny = DeviceLimits(sm_count=4, smem_per_block=4 * 1024)
    with pytest.raises(ValueError, match="shared memory"):
        pick_config(8192, 8192, 1, 1, 1000, 12, tiny, iters_per_pass=8)
    with pytest.raises(ValueError, match="halo"):
        pick_config(8, 8, 1, 1, 1000, 12, H100_SXM, iters_per_pass=9)
