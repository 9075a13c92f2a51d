"""The CUDA kernels' wrappers in the PyTorch/CUDA port.

This file imports no JAX, so its card tests run where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

(``--noconftest`` skips tests/conftest.py, which sets up JAX). Tests marked
``gpu`` need a CUDA card and skip without one; the others check, on the CPU,
that a wrapper given CPU tensors runs its plain version and launches nothing.

Tolerance on the card: atol 1e-4 at temperatures in [70, 90]. A kernel and
its plain version evaluate the same float32 operations in the same order,
so they agree to a few ulps (7.6e-6 at 80); with the strong coefficients
one iteration moves temperatures by ~1e-1.
"""

import numpy as np
import pytest
import torch

from stencilstream_tpu_torch import Grid, Params, create_update
from stencilstream_tpu_torch.backends import cuda_lib
from stencilstream_tpu_torch.backends import monotile as mt
from stencilstream_tpu_torch.backends import tile_pass as tp
from stencilstream_tpu_torch.models import hotspot as hs

STRONG = dict(Rx_1=np.float32(0.1), Ry_1=np.float32(0.1), Rz_1=np.float32(0.05), Cap_1=np.float32(0.5))
ATOL = 1e-4


def _cell(shape, seed, device, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return hs.HotspotCell(
        temp=torch.tensor(rng.uniform(70, 90, shape), dtype=dtype, device=device),
        power=torch.tensor(rng.uniform(0, 1e-3, shape), dtype=dtype, device=device),
    )


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


# -- on the CPU: plain versions, no launches ---------------------------------


def test_cpu_tensors_take_the_plain_versions():
    kernel = hs.HotspotKernel(**STRONG)
    halo = hs.HotspotCell(temp=5.0, power=0.25)
    cell = _cell((10, 13), 0, "cpu")
    before = (tp.launches, mt.launches)
    a = tp.tile_pass(cell, kernel, halo, i_start=0, offset=0, n_iterations=3, iters_per_pass=3)
    b = tp.tile_pass_plain(cell, kernel, halo, i_start=0, offset=0, n_iterations=3, iters_per_pass=3)
    c = mt.monotile(cell, kernel, halo, offset=0, n_iterations=3)
    d = mt.monotile_plain(cell, kernel, halo, offset=0, n_iterations=3)
    assert (tp.launches, mt.launches) == before
    assert torch.equal(a.temp, b.temp) and torch.equal(c.temp, d.temp) and torch.equal(a.temp, c.temp)


def test_build_is_keyed_by_the_sources():
    digest = cuda_lib.source_hash()
    assert len(digest) == 16 and digest == cuda_lib.source_hash()
    path = cuda_lib.library_path()
    assert path.parent == cuda_lib.BUILD_DIR and digest in path.name
    assert {"tile_pass.cu", "monotile.cu"} <= {p.name for p in cuda_lib.CSRC.glob("*.cu")}


def test_cell_smem_bytes_counts_variant_fields_twice():
    cell = _cell((2, 2), 0, "cpu")
    assert cuda_lib.cell_smem_bytes(cell, hs.HotspotKernel()) == 12
    assert cuda_lib.cell_smem_bytes(cell, object()) == 16
    assert cuda_lib.cell_smem_bytes(torch.zeros(2, 2), object()) == 8


# -- on the card --------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize(
    "shape,tile,p,i_start,offset,n",
    [((37, 53), (16, 32), 4, 7, 3, 5), ((20, 24), (64, 64), 8, 0, 0, 8), ((300, 260), (64, 64), 8, 2, 1, 20)],
)
def test_tile_pass_kernel_matches_plain_version(cuda, shape, tile, p, i_start, offset, n):
    kernel = hs.HotspotKernel(**STRONG)
    halo = hs.HotspotCell(temp=5.0, power=0.25)
    cell = _cell(shape, 9, cuda)
    before = tp.launches
    kw = dict(i_start=i_start, offset=offset, n_iterations=n, iters_per_pass=p)
    got = tp.tile_pass(cell, kernel, halo, tile=tile, **kw)
    want = tp.tile_pass_plain(cell, kernel, halo, **kw)
    torch.cuda.synchronize()
    assert tp.launches == before + 1
    assert float((got.temp - want.temp).abs().max()) <= ATOL
    assert got.power is cell.power


@pytest.mark.gpu
@pytest.mark.parametrize("shape,offset,n", [((37, 53), 3, 7), ((20, 24), 0, 1), ((1024, 1024), 2, 50)])
def test_monotile_kernel_matches_plain_version(cuda, shape, offset, n):
    kernel = hs.HotspotKernel(**STRONG)
    halo = hs.HotspotCell(temp=5.0, power=0.25)
    cell = _cell(shape, 9, cuda)
    before = mt.launches
    got = mt.monotile(cell, kernel, halo, offset=offset, n_iterations=n)
    want = mt.monotile_plain(cell, kernel, halo, offset=offset, n_iterations=n)
    torch.cuda.synchronize()
    assert mt.launches == before + 1
    assert float((got.temp - want.temp).abs().max()) <= ATOL
    assert got.power is cell.power


@pytest.mark.gpu
@pytest.mark.parametrize("shape,expect", [((512, 512), "monotile"), ((2304, 1024), "tiling")])
def test_auto_runs_the_kernels_on_the_card(cuda, shape, expect):
    grid = Grid(_cell(shape, 3, cuda))
    before = (tp.launches, mt.launches)
    got, update = hs.run(grid, 12, backend="auto")
    want, _ = hs.run(grid, 12, backend="reference")
    assert update.resolved_backend == expect
    launched = (tp.launches - before[0], mt.launches - before[1])
    assert launched == ((2, 0) if expect == "tiling" else (0, 1))
    assert float((got.arrays.temp - want.arrays.temp).abs().max()) <= ATOL


@pytest.mark.gpu
def test_kernels_refuse_what_they_cannot_run(cuda):
    halo = hs.HotspotCell(temp=0.0, power=0.0)

    class NoFunctor:
        stencil_radius = 1
        n_subiterations = 1

        def __call__(self, s):
            return s[0, 0]

        def get_time_dependent_value(self, i):
            return None

    for backend in ("tiling", "monotile"):
        update = create_update(Params(NoFunctor(), halo_value=halo), backend=backend)
        with pytest.raises(NotImplementedError, match="NoFunctor"):
            update(Grid(_cell((16, 16), 0, cuda)))
    kernel = hs.HotspotKernel(**STRONG)
    with pytest.raises(TypeError, match="float32"):
        mt.monotile(_cell((16, 16), 0, cuda, torch.float64), kernel, halo, offset=0, n_iterations=1)
    strided = hs.HotspotCell(temp=torch.zeros(16, 32, device=cuda)[:, ::2], power=torch.zeros(16, 16, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        tp.tile_pass(strided, kernel, halo, i_start=0, offset=0, n_iterations=1, iters_per_pass=1)
    big = _cell((4096, 4096), 0, cuda)
    with pytest.raises(ValueError, match="tiling"):
        mt.monotile(big, kernel, halo, offset=0, n_iterations=1)
