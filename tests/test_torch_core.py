"""Core of the PyTorch/CUDA port (stencilstream_tpu_torch) against the JAX
package: cells, grids, the Stencil view, TDV strategies, the transition
contract, and a radius-2 twin pair that reads the iteration, the
coordinates and unsigned taps under a non-zero halo value and offset.

Inputs are made with numpy and handed to both packages; JAX runs on the CPU.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencilstream_tpu import Grid as JGrid
from stencilstream_tpu import Params as JParams
from stencilstream_tpu import create_update as j_create_update
from stencilstream_tpu import cell_type as j_cell_type
from stencilstream_tpu import transition_function as j_transition_function

from stencilstream_tpu_torch import Grid, Params, create_update, interop
from stencilstream_tpu_torch import cell_type, transition_function
from stencilstream_tpu_torch.core import Stencil, validate_transition_function
from stencilstream_tpu_torch.core.cell import canonicalize_cell, cell_dtypes, cell_map, cell_zeros
from stencilstream_tpu_torch.tdv import (
    InlineTDV,
    PrecomputeOnDeviceTDV,
    PrecomputeOnHostTDV,
    resolve_tdv_strategy,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- a radius-2 twin pair ----------------------------------------------------


@j_cell_type
class JPair:
    a: jnp.ndarray
    b: jnp.ndarray


@j_transition_function
class JTwin:
    """Reads unsigned taps, the iteration, the coordinates and the halo."""

    stencil_radius = 2
    n_subiterations = 1
    w: float = 0.1

    def __call__(self, s):
        c = s[0, 0]
        far = s.uid(0, 0).a + s.uid(4, 4).a + s.uid(0, 4).b + s.uid(4, 0).b
        near = s[-1, 0].a + s[1, 0].a + s[0, -2].b + s[0, 2].b
        it = jnp.asarray(s.iteration, jnp.float32)
        coord = (s.row * 3 + s.col).astype(jnp.float32)
        a = c.a * 0.5 + self.w * (far + near) * 0.125 + it * 0.01
        b = c.b * 0.25 + coord * 0.001 + jnp.where(s.on_boundary(), 1.0, 0.0)
        return JPair(a=a, b=b)

    def get_time_dependent_value(self, i):
        return None


@cell_type
class Pair:
    a: torch.Tensor
    b: torch.Tensor


@transition_function
class Twin:
    """The torch twin of ``JTwin``, term by term."""

    stencil_radius = 2
    n_subiterations = 1
    w: float = 0.1

    def __call__(self, s):
        c = s[0, 0]
        far = s.uid(0, 0).a + s.uid(4, 4).a + s.uid(0, 4).b + s.uid(4, 0).b
        near = s[-1, 0].a + s[1, 0].a + s[0, -2].b + s[0, 2].b
        it = float(s.iteration)
        coord = (s.row * 3 + s.col).to(torch.float32)
        w = float(np.float32(self.w))
        a = c.a * 0.5 + w * (far + near) * 0.125 + it * np.float32(0.01).item()
        b = c.b * 0.25 + coord * np.float32(0.001).item() + torch.where(
            s.on_boundary(), torch.ones_like(c.b), torch.zeros_like(c.b)
        )
        return Pair(a=a, b=b)

    def get_time_dependent_value(self, i):
        return None


def _pair_inputs(shape, seed=5):
    rng = np.random.default_rng(seed)
    return JPair(
        a=rng.uniform(-1, 1, shape).astype(np.float32),
        b=rng.uniform(-1, 1, shape).astype(np.float32),
    )


@pytest.mark.parametrize("backend", ["reference", "tiling", "monotile", "auto"])
def test_radius2_twin_matches_jax_reference(backend):
    """Halo 0.75/-0.5, offset 4, n=5: the port on the CPU (its kernels'
    plain versions for tiling/monotile, with p=2 for tiling so the last
    pass is partial) against the JAX oracle. Tolerance rtol 1e-5, atol 1e-5:
    the twins round alike term by term, but float32 sums of ~10 terms may
    be associated differently by XLA."""
    np_cell = _pair_inputs((21, 30))
    j_out = j_create_update(
        JParams(
            transition_function=JTwin(),
            halo_value=JPair(a=jnp.float32(0.75), b=jnp.float32(-0.5)),
            iteration_offset=4,
            n_iterations=5,
        ),
        backend="reference",
    )(JGrid.from_numpy(np_cell)).to_numpy()

    kw = {"iters_per_pass": 2} if backend == "tiling" else {}
    out = create_update(
        Params(
            transition_function=interop.transition_function_from_fields(
                Twin, dataclasses.asdict(JTwin())
            ),
            halo_value=Pair(a=0.75, b=-0.5),
            iteration_offset=4,
            n_iterations=5,
        ),
        backend=backend,
        **kw,
    )(interop.grid_from_numpy(Pair, np_cell, device="cpu")).to_numpy()
    np.testing.assert_allclose(out.a, j_out.a, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.b, j_out.b, rtol=1e-5, atol=1e-5)


def test_twin_depends_on_halo_offset_and_coordinates():
    """The twin's result moves with the halo value and the offset, so the
    parity test above would see either one mishandled."""
    grid = interop.grid_from_numpy(Pair, _pair_inputs((12, 12)), device="cpu")

    def run(halo, offset):
        return create_update(
            Params(Twin(), halo_value=Pair(a=halo, b=0.0), iteration_offset=offset, n_iterations=2),
            backend="reference",
        )(grid).to_numpy().a

    base = run(0.0, 0)
    assert np.abs(run(0.75, 0) - base).max() > 1e-3
    assert np.abs(run(0.0, 4) - base).max() > 1e-3


def test_fused_substep_masks_a_window_that_leaves_the_grid():
    """The plain sub-step building block against JAX's, pad/pad, on a
    window that overhangs the grid's top-left corner by 2 rows and 3
    columns (out-of-grid cells must come back as the halo value)."""
    from stencilstream_tpu.backends import fused as jfused

    from stencilstream_tpu_torch.backends import fused

    np_cell = _pair_inputs((9, 10), 8)
    j_halo = JPair(a=jnp.float32(0.75), b=jnp.float32(-0.5))
    j_win = jfused.mask_out_of_grid(
        JPair(a=jnp.asarray(np_cell.a), b=jnp.asarray(np_cell.b)), j_halo, (-2, -3), (7, 7)
    )
    j_out, _, _ = jfused.fused_substep(
        j_win, JTwin(), j_halo, -2, -3, (7, 7), jnp.int32(4), None, True,
        radius=2, n_subiterations=1,
    )
    halo = Pair(a=0.75, b=-0.5)
    win = fused.mask_out_of_grid(
        interop.grid_from_numpy(Pair, np_cell, device="cpu").arrays, halo, (-2, -3), (7, 7)
    )
    out = fused.fused_substep(win, Twin(), halo, -2, -3, (7, 7), 4, None, True, radius=2, n_subiterations=1)
    np.testing.assert_allclose(out.a.numpy(), np.asarray(j_out.a), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.b.numpy(), np.asarray(j_out.b), rtol=1e-5, atol=1e-5)
    assert float(out.a[0, 5]) == 0.75 and float(out.b[4, 1]) == -0.5
    assert fused.fused_substep(win, Twin(), halo, -2, -3, (7, 7), 4, None, False,
                               radius=2, n_subiterations=1) is win


# -- the port imports no JAX -------------------------------------------------


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import stencilstream_tpu_torch\n"
        "from stencilstream_tpu_torch.models import hotspot\n"
        "from stencilstream_tpu_torch import interop\n"
        "from stencilstream_tpu_torch.backends import auto, monotile, tiling, tile_pass, cuda_lib\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'stencilstream_tpu.'))\n"
        "       or m == 'stencilstream_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


# -- cells, grids, the Stencil view ------------------------------------------


def test_cell_helpers():
    c = Pair(a=torch.ones(2, 3), b=torch.zeros(2, 3, dtype=torch.int32))
    assert cell_dtypes(c) == Pair(a=torch.float32, b=torch.int32)
    assert cell_zeros(c) == Pair(a=0, b=0)
    assert cell_dtypes(Pair(a=1.5, b=3)) == Pair(a=torch.float32, b=torch.int32)
    doubled = cell_map(lambda x: x * 2, c)
    assert torch.equal(doubled.a, torch.full((2, 3), 2.0))
    canon = canonicalize_cell(Pair(a=torch.ones(2, 3, dtype=torch.float64), b=7), c)
    assert canon.a.dtype == torch.float32 and canon.b.dtype == torch.int32
    assert torch.equal(canon.b, torch.full((2, 3), 7, dtype=torch.int32))
    with pytest.raises(TypeError):
        cell_map(lambda x, y: x, c, torch.ones(2, 3))


def test_grid_roundtrip_and_helpers():
    rng = np.random.default_rng(0)
    arrays = Pair(a=rng.random((4, 5)).astype(np.float32), b=rng.random((4, 5)).astype(np.float32))
    g = Grid.from_numpy(arrays, device="cpu")
    assert g.shape == (4, 5) and g.height == 4 and g.width == 5 and g.range == (4, 5)
    back = g.to_numpy()
    np.testing.assert_array_equal(back.a, arrays.a)
    assert float(g.cell_at(1, 2).b) == arrays.b[1, 2]
    g2 = g.set_cell(1, 2, Pair(a=9.0, b=8.0))
    assert float(g2.cell_at(1, 2).a) == 9.0 and float(g.cell_at(1, 2).a) == arrays.a[1, 2]
    assert float(g.make_similar().arrays.a.abs().sum()) == 0.0
    full = Grid.full(2, 3, Pair(a=1.5, b=2.5), device="cpu")
    assert torch.equal(full.arrays.b, torch.full((2, 3), 2.5))
    z = Grid.zeros(2, 2, Pair(a=1.0, b=1.0), device="cpu")
    assert float(z.arrays.a.sum()) == 0.0
    assert g.block_until_ready() is g
    with pytest.raises(ValueError):
        Grid.from_numpy(Pair(a=np.zeros((2, 2)), b=np.zeros((3, 2))), device="cpu")


def test_stencil_signed_unsigned_and_boundary():
    def neighbor(dr, dc):
        return dr * 10 + dc

    row, col = torch.meshgrid(torch.arange(3), torch.arange(4), indexing="ij")
    s = Stencil(neighbor, 2, (row, col), (3, 4), iteration=7, subiteration=0, time_dependent_value="t")
    assert s[-2, 1] == -19 and s.uid(0, 3) == -19 and s.center == 0
    assert s.diameter == 5 and s.tdv == "t" and s.iteration == 7
    with pytest.raises(IndexError):
        s[3, 0]
    edge = s.on_boundary()
    assert bool(edge[0, 1]) and bool(edge[1, 3]) and not bool(edge[1, 1])


def test_stencil_offset_is_cached():
    calls = []

    def neighbor(dr, dc):
        calls.append((dr, dc))
        return dr

    s = Stencil(neighbor, 1, (0, 0), (1, 1), 0, 0)
    s[1, 0], s[1, 0], s.uid(2, 1)
    assert calls == [(1, 0)]


def test_validate_transition_function():
    class NoRadius:
        n_subiterations = 1

        def __call__(self, s):
            return s[0, 0]

    with pytest.raises(TypeError, match="stencil_radius"):
        validate_transition_function(NoRadius())
    validate_transition_function(Twin())


# -- TDV strategies ----------------------------------------------------------


@transition_function
class Source:
    """Adds its TDV (a per-iteration amplitude) to every cell."""

    stencil_radius = 1
    n_subiterations = 1
    tdv_host_batchable = False

    def __call__(self, s):
        return s[0, 0] + s.tdv

    def get_time_dependent_value(self, i):
        return (i * 0.5 + 1.0) if not isinstance(i, torch.Tensor) else i.to(torch.float32) * 0.5 + 1.0


@pytest.mark.parametrize("strategy", ["inline", "precompute_on_device", "precompute_on_host"])
@pytest.mark.parametrize("backend", ["reference", "tiling", "monotile"])
def test_tdv_strategies_agree(strategy, backend):
    """Every strategy gives the same TDV stream (offset 3, n=4), on the
    reference and on the plain versions of both kernels; exact in float32."""
    grid = Grid.from_numpy(np.zeros((5, 6), np.float32), device="cpu")
    kw = {"iters_per_pass": 3} if backend == "tiling" else {}
    out = create_update(
        Params(Source(), iteration_offset=3, n_iterations=4, tdv_strategy=strategy),
        backend=backend,
        **kw,
    )(grid).to_numpy()
    expect = sum(i * 0.5 + 1.0 for i in range(3, 7))
    np.testing.assert_array_equal(out, np.full((5, 6), expect, np.float32))


def test_tdv_strategy_resolution():
    assert isinstance(resolve_tdv_strategy("inline"), InlineTDV)
    assert isinstance(resolve_tdv_strategy(PrecomputeOnHostTDV), PrecomputeOnHostTDV)
    strategy = PrecomputeOnDeviceTDV()
    assert resolve_tdv_strategy(strategy) is strategy
    with pytest.raises(ValueError):
        resolve_tdv_strategy("nope")
    aux = PrecomputeOnDeviceTDV().prepare(Source(), 2, 3, "cpu")
    assert [float(aux[i]) for i in range(3)] == [2.0, 2.5, 3.0]


# -- no device functor, no kernels -------------------------------------------


@pytest.mark.parametrize("backend", ["tiling", "monotile"])
def test_kernel_backends_refuse_transition_function_without_functor(backend):
    update = create_update(Params(Twin(), n_iterations=1), backend=backend)
    with pytest.raises(NotImplementedError, match="Twin"):
        update.require_device_op()


@pytest.mark.parametrize("backend", ["tiling", "monotile"])
def test_kernel_backends_refuse_time_dependent_value(backend):
    from stencilstream_tpu_torch.models.hotspot import HotspotKernel

    class WithTDV(HotspotKernel):
        def get_time_dependent_value(self, i):
            return 1.0

    update = create_update(Params(HotspotKernel(), n_iterations=1), backend=backend)
    assert update.require_device_op() == "hotspot"
    update.get_params().transition_function = WithTDV()
    with pytest.raises(NotImplementedError, match="time-dependent"):
        update.require_device_op()
