"""The line-cache window mode of the PyTorch/CUDA port's tiling backend
against the JAX package's, and its configuration law.

JAX runs ``tiling(window_mode="linecache")`` in Pallas interpret mode. It
runs its line-cache kernel only on a grid at least 128 rows tall and a
multiple of 128 wide: a shorter grid is run transposed, and its transposed
width then falls back to clamped. The Jacobi and HotSpot cases are sized so
that JAX takes its line-cache kernel, and check that it did; the blinker,
resume and probe cases keep the shapes of tests/test_linecache.py, where
JAX takes that fallback, which computes the same function. On the CPU the
port runs the line-cache kernel's plain version (one tile pass's: the same
function).

JAX's line-cache kernel in interpret mode does not round like JAX's
reference: XLA fuses its tap graph's multiply-adds differently, and 1-ulp
differences reach a quarter of the Jacobi cells after 8 iterations. So the
Jacobi and HotSpot cases hold the port to JAX's reference exactly and to
JAX's line-cache path within a few ulps (rtol 1e-6, atol 1e-6: an ulp is
at most 6e-8 for Jacobi's values in [0, 1] and 7.6e-6 for HotSpot's
temperatures near 80). Every other comparison is exact. The kernel itself
is held against its plain version on the card by tests/test_torch_kernels.py
and chip_smoke.py.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencilstream_tpu.backends import create_update as j_create_update
from stencilstream_tpu.core import Grid as JGrid
from stencilstream_tpu.core import Params as JParams
from stencilstream_tpu.models import conway as jc
from stencilstream_tpu.models import hotspot as jhs
from stencilstream_tpu.models import jacobi as jj

from probe import ProbeTransFunc as JProbe
from probe import make_probe_grid as j_make_probe_grid
from probe import probe_halo_cell as j_probe_halo

from stencilstream_tpu_torch import Grid, Params, create_update, interop, probe
from stencilstream_tpu_torch.backends import line_cache as lc
from stencilstream_tpu_torch.backends.cuda_lib import H100_SXM, DeviceLimits
from stencilstream_tpu_torch.models import conway, hotspot, jacobi

COEFS = [0.15, 0.2, 0.25, 0.1, 0.3]


def _jax_linecache(params, **kw):
    update = j_create_update(params, backend="tiling", window_mode="linecache", **kw)
    update.fallback_to_reference = False
    return update


def _port_linecache(params, **kw):
    return create_update(params, backend="tiling", window_mode="linecache", **kw)


@pytest.mark.parametrize("n,p,T", [(8, 4, 16), (5, 4, 16)], ids=["full", "partial"])
def test_jacobi_matches_jax(n, p, T):
    x = np.random.default_rng(0).random((160, 128), np.float32)
    j_params = JParams(transition_function=jj.make_kernel("jacobi5_general", COEFS), n_iterations=n)
    j_update = _jax_linecache(j_params, strip_rows=T, iters_per_pass=p)
    j_linecache = j_update(JGrid.from_numpy(x)).to_numpy()
    assert j_update.resolved_config["window_mode"] == "linecache"
    want = j_create_update(j_params, backend="reference")(JGrid.from_numpy(x)).to_numpy()
    update = _port_linecache(
        Params(jacobi.make_kernel("jacobi5_general", COEFS), halo_value=0.0, n_iterations=n),
        strip_rows=T, iters_per_pass=p,
    )
    got = update(Grid.from_numpy(x, device="cpu")).to_numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, j_linecache, rtol=1e-6, atol=1e-6)
    assert update.resolved_config == dict(
        window_mode="linecache", strip_rows=T, panel_cols=152, segment_rows=64, iters_per_pass=p
    )


@pytest.mark.parametrize("n", [8, 6], ids=["full", "partial"])
def test_hotspot_invariant_field_matches_jax(n):
    """HotSpot 144x128, p=4, T=16: the boundary handled inside the
    transition function, the power field passed through untouched."""
    rng = np.random.default_rng(1)
    cell = jhs.HotspotCell(
        temp=rng.uniform(70, 90, (144, 128)).astype(np.float32),
        power=rng.uniform(0, 1e-3, (144, 128)).astype(np.float32),
    )
    jkernel = jhs.derive_coefficients(144, 128)
    j_params = JParams(
        transition_function=jkernel,
        halo_value=jhs.HotspotCell(temp=jnp.float32(0), power=jnp.float32(0)),
        n_iterations=n,
    )
    j_update = _jax_linecache(j_params, strip_rows=16, iters_per_pass=4)
    j_linecache = j_update(JGrid.from_numpy(cell)).to_numpy()
    assert j_update.resolved_config["window_mode"] == "linecache"
    want = j_create_update(j_params, backend="reference")(JGrid.from_numpy(cell)).to_numpy()
    grid = interop.hotspot_grid(cell, device="cpu")
    out = _port_linecache(
        Params(
            interop.hotspot_kernel(jkernel),
            halo_value=hotspot.HotspotCell(temp=0.0, power=0.0),
            n_iterations=n,
        ),
        strip_rows=16, iters_per_pass=4,
    )(grid)
    np.testing.assert_array_equal(out.to_numpy().temp, want.temp)
    np.testing.assert_allclose(out.to_numpy().temp, j_linecache.temp, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(out.to_numpy().power, j_linecache.power)
    assert out.arrays.power is grid.arrays.power


def test_conway_blinker_matches_jax():
    g = np.zeros((16, 128), bool)
    g[3, 2:5] = True  # horizontal blinker
    want = _jax_linecache(
        JParams(transition_function=jc.ConwayKernel(), halo_value=jnp.asarray(False), n_iterations=2),
        strip_rows=8, iters_per_pass=2,
    )(JGrid.from_numpy(g)).to_numpy()
    out, update = conway.run(
        interop.conway_grid(g, device="cpu"), 2, backend="tiling",
        window_mode="linecache", strip_rows=8, iters_per_pass=2,
    )
    np.testing.assert_array_equal(out.to_numpy(), want)
    np.testing.assert_array_equal(out.to_numpy(), g)
    assert update.resolved_config["window_mode"] == "linecache"


def test_resume_equivalence():
    """n=6 in one call equals 3 + 3 split with iteration_offset, and JAX's
    single call."""
    x = np.random.default_rng(3).random((48, 128), np.float32)
    kernel = jacobi.make_kernel("jacobi5_general", COEFS)

    def port(n, offset, grid):
        return _port_linecache(
            Params(kernel, halo_value=0.0, iteration_offset=offset, n_iterations=n),
            strip_rows=16, iters_per_pass=4,
        )(grid)

    combined = port(6, 0, Grid.from_numpy(x, device="cpu"))
    split = port(3, 3, port(3, 0, Grid.from_numpy(x, device="cpu")))
    np.testing.assert_array_equal(combined.to_numpy(), split.to_numpy())
    want = _jax_linecache(
        JParams(transition_function=jj.make_kernel("jacobi5_general", COEFS), n_iterations=6),
        strip_rows=16, iters_per_pass=4,
    )(JGrid.from_numpy(x)).to_numpy()
    np.testing.assert_array_equal(combined.to_numpy(), want)


@pytest.mark.parametrize("tdv", ["inline", "precompute_on_host", "precompute_on_device"])
def test_probe_contract_matches_jax(tdv):
    """The probe on 24x128 from iteration offset 2, n=3 (a partial last
    pass of p=2), under each TDV strategy: every cell Normal and at
    iteration 5, equal to JAX's."""
    want = _jax_linecache(
        JParams(
            transition_function=JProbe(), halo_value=j_probe_halo(),
            iteration_offset=2, n_iterations=3, tdv_strategy=tdv,
        ),
        strip_rows=8, iters_per_pass=2,
    )(j_make_probe_grid(24, 128, iteration_offset=2)).to_numpy()
    out = _port_linecache(
        Params(
            probe.ProbeTransFunc(), halo_value=probe.probe_halo_cell(),
            iteration_offset=2, n_iterations=3, tdv_strategy=tdv,
        ),
        strip_rows=8, iters_per_pass=2,
    )(probe.make_probe_grid(24, 128, 2, device="cpu"))
    probe.check_probe_grid(out, 5)
    got = out.to_numpy()
    for name in ("r", "c", "i_iteration", "i_subiteration", "status"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))


def test_runs_where_jax_falls_back_to_clamped():
    """24x40: JAX warns and runs clamped (the width is not lane-aligned);
    the port runs the line-cache mode and reports it; results equal."""
    x = np.random.default_rng(2).random((24, 40), np.float32)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        j_update = _jax_linecache(
            JParams(transition_function=jj.make_kernel("jacobi5_general", COEFS), n_iterations=4),
            strip_rows=8, iters_per_pass=2,
        )
        want = j_update(JGrid.from_numpy(x)).to_numpy()
    assert j_update.resolved_config["window_mode"] == "clamped"
    assert any("falling back" in str(w.message) for w in caught)
    update = _port_linecache(
        Params(jacobi.make_kernel("jacobi5_general", COEFS), halo_value=0.0, n_iterations=4),
        strip_rows=8, iters_per_pass=2,
    )
    np.testing.assert_array_equal(update(Grid.from_numpy(x, device="cpu")).to_numpy(), want)
    assert update.resolved_config["window_mode"] == "linecache"


def test_config_law():
    """A pure function of the shape and the device's limits."""
    law = lc.pick_linecache_config
    # Jacobi5 at 8192^2 (4 B a cell): strips of 32 rows and a 160-column
    # window at halo 8, so panels of 144 and p=8. A CTA takes 4 B x (2 x 34 +
    # 7 x 2) rows x 160 columns + 16 = 52496 B; the law counts 4 CTAs per SM
    # (what the occupancy calculator reported), so 3 waves of 4 x 132 CTAs
    # over 57 panels give 27 segments of 320 rows.
    assert law(8192, 8192, 1, 1, 200, 4, 0, H100_SXM) == (32, 144, 320, 8)
    assert lc.line_cache_smem_bytes(32, 144, 1, 8, 4, 0) == 52496
    assert lc.ctas_per_sm(52496, H100_SXM, 4) == 4 and lc.ctas_per_sm(100_000, H100_SXM, 4) == 2
    # HotSpot (8 B, a 41-row power plane besides): a 192-column window, 2 CTAs
    # per SM, 3 waves; Conway (1 B): 192 columns, 5 CTAs per SM, 2 waves.
    assert law(8192, 8192, 1, 1, 200, 4, 4, H100_SXM) == (32, 176, 512, 8)
    assert law(8192, 8192, 1, 1, 200, 1, 0, H100_SXM) == (32, 176, 320, 8)
    # Small grids: no wider a window than the grid needs, no segment shorter
    # than four warm-ups (4 x 32 rows).
    assert law(1000, 1000, 1, 1, 200, 4, 0, H100_SXM) == (32, 144, 128, 8)
    assert law(20, 24, 1, 1, 200, 4, 0, H100_SXM) == (32, 48, 32, 8)
    # p=4, T=16: warm-up 16 rows, so 96 rows make two segments of 48.
    assert law(96, 128, 1, 1, 5, 4, 0, H100_SXM, iters_per_pass=4, strip_rows=16) == (16, 152, 48, 4)
    assert law(8192, 8192, 1, 1, 3, 4, 0, H100_SXM).iters_per_pass == 3
    # The probe: 20 B of variant fields, k=2: strips of 8 rows and a
    # 128-column window at halo 4, p=2.
    assert law(8192, 8192, 1, 2, 200, 20, 0, H100_SXM) == (8, 120, 488, 2)
    # A smaller card: the window narrows, then the strip, then p, until a CTA
    # fits half its shared memory (or, at the smallest, all of it).
    small = DeviceLimits(sm_count=16, smem_per_block=48 * 1024)
    assert law(8192, 8192, 1, 1, 200, 4, 0, small) == (32, 48, 8192, 8)
    assert lc.line_cache_smem_bytes(32, 48, 1, 8, 4, 0) <= small.smem_per_block // 2
    assert law(8192, 8192, 1, 1, 200, 4, 0, DeviceLimits(16, 16 * 1024)) == (8, 52, 8192, 6)
    with pytest.raises(ValueError, match="shared memory"):
        law(8192, 8192, 1, 1, 200, 4, 0, DeviceLimits(16, 4 * 1024), iters_per_pass=8)


#: (variant bytes, invariant bytes, sub-iterations) of the cells the law
#: sizes: Jacobi5, HotSpot, Conway, the probe.
CELLS = [(4, 0, 1), (4, 4, 1), (1, 0, 1), (20, 0, 2)]
SHAPES = [(8192, 8192), (1000, 1000), (300, 260), (20, 24), (64, 8192)]
LIMITS = [H100_SXM, DeviceLimits(sm_count=16, smem_per_block=48 * 1024)]


def _law_cases():
    return [(cell, shape, limits) for cell in CELLS for shape in SHAPES for limits in LIMITS]


def _layout_bytes(strip, panel, radius, steps, variant, invariant):
    """The kernel's shared-memory layout (csrc/line_cache.cu), counted plane
    by plane: pitch = window rounded up to 16 elements."""
    hp = radius * steps
    pitch = -(-(panel + 2 * hp) // 16) * 16
    planes = 2 * (2 * radius + strip) * pitch * variant
    carries = max(steps - 1, 0) * 2 * radius * pitch * variant
    invariants = (strip + hp + radius) * pitch * invariant
    return planes + carries + invariants + 16


@pytest.mark.parametrize("cell,shape,limits", _law_cases())
def test_law_window_is_whole_warps(cell, shape, limits):
    """The window (panel + 2 halos) is a whole number of warps, so every
    level of the narrowing window covers the same 32-column chunks; it is
    the law's window where the grid is that wide and a CTA of it fits."""
    variant, invariant, k = cell
    cfg = lc.pick_linecache_config(*shape, 1, k, 200, variant, invariant, limits)
    hp = cfg.iters_per_pass * k
    window = cfg.panel_cols + 2 * hp
    assert window % lc.WARP == 0 and cfg.panel_cols >= lc.WARP
    law = lc.law_entry(variant + invariant)
    fits = lc.line_cache_smem_bytes(cfg.strip_rows, law.window_cols - 2 * hp, 1, hp, variant, invariant)
    if shape[1] + 2 * hp >= law.window_cols and fits <= limits.smem_per_block // law.sized_for:
        assert window == law.window_cols


@pytest.mark.parametrize("cell,shape,limits", _law_cases())
def test_law_strip_is_whole_runs_and_holds_the_carry(cell, shape, limits):
    variant, invariant, k = cell
    cfg = lc.pick_linecache_config(*shape, 1, k, 200, variant, invariant, limits)
    assert cfg.strip_rows % lc.RUN_ROWS == 0 and cfg.strip_rows >= 2
    assert cfg.segment_rows % cfg.strip_rows == 0


@pytest.mark.parametrize("strip,panel,steps,variant,invariant",
                         [(32, 112, 8, 4, 0), (32, 112, 8, 4, 4), (64, 240, 8, 1, 0), (16, 60, 2, 20, 0),
                          (8, 32, 1, 4, 4), (32, 64, 0, 4, 0)])
def test_smem_bytes_is_the_kernels_layout(strip, panel, steps, variant, invariant):
    assert lc.line_cache_smem_bytes(strip, panel, 1, steps, variant, invariant) == \
        _layout_bytes(strip, panel, 1, steps, variant, invariant)


@pytest.mark.parametrize("cell,shape,limits", _law_cases())
def test_law_cta_fits_the_shared_memory_it_counted_on(cell, shape, limits):
    """A CTA fits one block, and the CTAs per SM the law counted on fit the
    SM together; the segments of all panels make at most the law's waves of
    them."""
    variant, invariant, k = cell
    cfg = lc.pick_linecache_config(*shape, 1, k, 200, variant, invariant, limits)
    smem = lc.line_cache_smem_bytes(cfg.strip_rows, cfg.panel_cols, 1, cfg.iters_per_pass * k, variant, invariant)
    per_sm = lc.ctas_per_sm(smem, limits, lc.law_entry(variant + invariant)[3])
    assert smem * per_sm <= limits.smem_per_block
    n_ctas = -(-shape[1] // cfg.panel_cols) * -(-shape[0] // cfg.segment_rows)
    waves = lc.law_entry(variant + invariant)[4]
    assert n_ctas <= max(per_sm * limits.sm_count * waves, -(-shape[1] // cfg.panel_cols))


@pytest.mark.parametrize(
    "panel, halo, strip, segment, warmup, want",
    [
        # A 128-column window at halo 8: every level in four 32-column chunks,
        # 11 strips walked for a 320-row segment.
        (112, 8, 32, 320, 32, 8 * 128 * 352 / (112 * 8 * 320)),
        # One level on a whole-warp window, no warm-up: only the halo columns.
        (30, 1, 8, 64, 0, 32 / 30),
    ],
)
def test_line_cache_work_counts_whole_chunks_and_the_warm_up(panel, halo, strip, segment, warmup, want):
    from stencilstream_tpu_torch.tile_sweep import line_cache_work

    assert line_cache_work(panel, halo, 1, strip, segment, warmup) == pytest.approx(want)


def test_a_strip_must_be_whole_runs_and_a_panel_a_warp():
    """A strip that is not a whole number of 8-row runs, and a panel
    narrower than a warp, raise on the CPU as on the card."""
    grid = Grid.from_numpy(np.zeros((16, 64), np.float32), device="cpu")
    kw = dict(i_start=0, offset=0, n_iterations=1, iters_per_pass=1, segment_rows=16)
    kernel = jacobi.make_kernel("jacobi5_general", COEFS)
    with pytest.raises(ValueError, match="runs"):
        lc.line_cache_pass(grid.arrays, kernel, 0.0, strip_rows=12, panel_cols=32, **kw)
    with pytest.raises(ValueError, match="panel_cols"):
        lc.line_cache_pass(grid.arrays, kernel, 0.0, strip_rows=8, panel_cols=16, **kw)
    update = _port_linecache(Params(kernel, halo_value=0.0, n_iterations=2), strip_rows=12)
    with pytest.raises(ValueError, match="runs"):
        update(grid)


def test_a_strip_must_hold_the_carried_rows():
    """2r > strip_rows raises; nothing falls back to the clamped mode."""
    grid = Grid.from_numpy(np.zeros((16, 16), np.float32), device="cpu")
    update = _port_linecache(
        Params(jacobi.make_kernel("jacobi5_general", COEFS), halo_value=0.0, n_iterations=2),
        strip_rows=1,
    )
    with pytest.raises(ValueError, match="strip_rows"):
        update(grid)
    with pytest.raises(ValueError, match="strip_rows"):
        lc.line_cache_pass(
            grid.arrays, jacobi.make_kernel("jacobi2_constant"), 0.0,
            i_start=0, offset=0, n_iterations=1, iters_per_pass=1, strip_rows=1, panel_cols=32,
            segment_rows=16,
        )


def test_options_are_checked():
    params = Params(jacobi.make_kernel("jacobi2_constant"), n_iterations=1)
    with pytest.raises(ValueError, match="window_mode"):
        create_update(params, backend="tiling", window_mode="extended")
    with pytest.raises(ValueError, match="linecache"):
        create_update(params, backend="tiling", strip_rows=16)


def test_auto_forwards_the_window_mode():
    """2048^2 does not fit the resident grid (18 rows x 2050 x 8 B > 227
    KB), so auto runs tiling, in the mode asked for."""
    x = np.random.default_rng(4).random((2048, 2048), np.float32)
    update = create_update(
        Params(jacobi.make_kernel("jacobi5_general", COEFS), halo_value=0.0, n_iterations=1),
        backend="auto", window_mode="linecache",
    )
    update(Grid.from_numpy(x, device="cpu"))
    assert update.resolved_backend == "tiling"
    assert update.resolved_config["window_mode"] == "linecache"


def test_cpu_tensors_take_the_plain_version():
    x = torch.tensor(np.random.default_rng(5).random((10, 13), np.float32))
    kernel = jacobi.make_kernel("jacobi5_general", COEFS)
    before = lc.launches
    kw = dict(i_start=1, offset=0, n_iterations=3, iters_per_pass=4)
    got = lc.line_cache_pass(x, kernel, 0.5, strip_rows=8, panel_cols=32, segment_rows=8, **kw)
    assert lc.launches == before
    assert torch.equal(got, lc.line_cache_pass_plain(x, kernel, 0.5, **kw))
