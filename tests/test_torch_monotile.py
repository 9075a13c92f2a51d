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

from stencilstream_tpu_torch import Grid, Params, create_update, interop, probe
from stencilstream_tpu_torch.backends import monotile as mt
from stencilstream_tpu_torch.backends.cuda_lib import H100_SXM, DeviceLimits, cell_smem_bytes
from stencilstream_tpu_torch.backends.monotile import monotile_plan
from stencilstream_tpu_torch.backends.reference import single_subiteration
from stencilstream_tpu_torch.core.cell import cell_field_names, cell_leaves, cell_unflatten
from stencilstream_tpu_torch.models import hotspot as hs
from stencilstream_tpu_torch.models import jacobi

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


def test_auto_plans_a_monotile_call_once(monkeypatch):
    """``auto`` hands the plan it routed by to ``monotile``, which plans no
    second time; ``monotile`` on its own plans for itself."""
    plans = []
    plan = mt.monotile_plan
    monkeypatch.setattr(mt, "monotile_plan", lambda *args: plans.append(args) or plan(*args))
    grid = interop.hotspot_grid(_np_cell((32, 64)), device="cpu")
    params = Params(hs.HotspotKernel(**STRONG), n_iterations=3)
    update = create_update(params, backend="auto")
    got = update(grid)
    assert update.resolved_backend == "monotile" and len(plans) == 1
    update(grid)
    assert len(plans) == 2
    want = create_update(params, backend="monotile")(grid)
    assert len(plans) == 3
    np.testing.assert_array_equal(got.to_numpy().temp, want.to_numpy().temp)


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


# -- the resident-grid kernel's band decomposition ----------------------------


def emulate_bands(arrays, tf, halo_cell, *, offset, n_iterations, plan):
    """The band decomposition of ``csrc/monotile.cu``, emulated in torch on
    the CPU with the reference sub-step: each of ``plan.n_ctas`` bands keeps
    two ping-pong planes of ``band + 2*q*r`` rows (a deep halo of ``q*r``
    rows a side; rows outside the grid hold the halo value and are never
    computed); every ``q`` sub-steps the bands trade their top and bottom
    ``q*r`` rows with the bands beside them, and in between sub-step j of a
    group of g computes the band plus ``(g-j)*r`` rows a side. The plane
    that a sub-step writes holds poison (NaN, or -7777 for integer fields)
    in every in-grid row of a variant field that no sub-step has written
    yet, so a row read before it is computed shows in the result."""
    leaves, halo = cell_leaves(arrays), cell_leaves(halo_cell)
    names = cell_field_names(arrays)
    variant = [j for j, name in enumerate(names) if name in tf.cuda_variant] if names else [0]
    H, W = leaves[0].shape
    r, K = tf.stencil_radius, tf.n_subiterations
    band, nb, q = plan.band, plan.n_ctas, plan.q
    assert q * r <= band and nb == -(-H // band)
    qr = q * r
    rows = band + 2 * qr

    def plane(b, poison):
        top = b * band - qr
        lo, hi = max(top, 0), min(top + rows, H)
        out = []
        for j, (t, h) in enumerate(zip(leaves, halo)):
            p = torch.full((rows, W), h, dtype=t.dtype)
            if poison and j in variant:
                p[lo - top:hi - top] = float("nan") if t.dtype.is_floating_point else -7777
            else:
                p[lo - top:hi - top] = t[lo:hi]
            out.append(p)
        return out

    cur = [plane(b, False) for b in range(nb)]
    other = [plane(b, True) for b in range(nb)]
    steps = n_iterations * K
    iteration, sub = offset, 0
    for s0 in range(0, steps, q):
        group = min(q, steps - s0)
        if s0 > 0:
            for b in range(nb):
                for j in variant:
                    if b > 0:
                        cur[b][j][:qr] = cur[b - 1][j][band:band + qr]
                    if b < nb - 1:
                        cur[b][j][qr + band:] = cur[b + 1][j][qr:2 * qr]
        for m in range((group - 1) * r, -1, -r):
            for b in range(nb):
                top = b * band - qr
                lo, hi = max(qr - m, -top), min(qr + band + m, H - top)
                new = cell_leaves(single_subiteration(
                    cell_unflatten(arrays, cur[b]), tf, halo_cell, iteration, sub, None,
                    radius=r, grid_range=(H, W), origin=(top, 0),
                ))
                for j in variant:
                    other[b][j][lo:hi] = new[j][lo:hi]
            cur, other = other, cur
            sub += 1
            if sub == K:
                sub, iteration = 0, iteration + 1
    return cell_unflatten(arrays, [
        torch.cat([cur[b][j][qr:qr + min(band, H - b * band)] for b in range(nb)])
        for j in range(len(leaves))
    ])


def _op_case(op, shape, iteration):
    """(cell, transition function, halo cell) on the CPU, from a numpy seed;
    non-zero halos; the probe's cells sit at ``iteration``."""
    rng = np.random.default_rng(11)
    if op == "hotspot":
        cell = _np_cell(shape, 11)
        return (hs.HotspotCell(temp=torch.tensor(cell.temp), power=torch.tensor(cell.power)),
                hs.HotspotKernel(**STRONG), hs.HotspotCell(temp=5.0, power=0.25))
    if op == "jacobi5":
        return (torch.tensor(rng.random(shape, np.float32)),
                jacobi.make_kernel("jacobi5_general", [0.15, 0.2, 0.25, 0.1, 0.3]), 5.0)
    return probe.make_probe_grid(*shape, iteration, device="cpu").arrays, probe.ProbeKernel(), probe.probe_halo_cell()


#: (shape, q): one-row bands that force q=1; 8-row bands with a ragged last
#: band of 6 rows; 5-row bands.
BAND_CASES = [((37, 53), 1), ((1030, 64), 1), ((1030, 64), 2), ((1030, 64), 4),
              ((600, 40), 1), ((600, 40), 2), ((600, 40), 4)]


@pytest.mark.parametrize("op", ["hotspot", "jacobi5", "probe"])
@pytest.mark.parametrize("shape,q", BAND_CASES, ids=[f"{h}x{w}-q{q}" for (h, w), q in BAND_CASES])
def test_band_decomposition_matches_plain_version(op, shape, q):
    """n=5 (the probe n=3, k=2) from iteration 3: n*k is not a multiple of
    q for q=2 and 4 (but for the probe at q=2), so the last group is short.
    The emulation and monotile_plain run the same float32 sub-steps on the
    same rows, so they agree exactly; monotile_plain is held against JAX
    monotile above."""
    cell, tf, halo = _op_case(op, shape, 3)
    n = 3 if op == "probe" else 5
    plan = monotile_plan(*shape, tf.stencil_radius, cell_smem_bytes(cell, tf), H100_SXM)._replace(q=q)
    got = emulate_bands(cell, tf, halo, offset=3, n_iterations=n, plan=plan)
    want = mt.monotile_plain(cell, tf, halo, offset=3, n_iterations=n)
    for g, w in zip(cell_leaves(got), cell_leaves(want)):
        assert torch.equal(g, w)
    if op == "probe":
        assert int(got.status.abs().max()) == probe.NORMAL
        assert int(got.i_iteration.min()) == 3 + n


def test_mono_law_picks_q_and_threads():
    """MONO_LAW's (q, threads) by cell bytes; the largest tabulated cell not
    larger than the cell's, the smallest for a smaller cell."""
    for cell_bytes, (q, threads) in mt.MONO_LAW.items():
        assert q >= 1 and threads in (512, 1024)
        assert mt.law_entry(cell_bytes) == (q, threads)
        assert mt.law_entry(cell_bytes + 1) == (q, threads)
    assert mt.law_entry(1) == mt.MONO_LAW[min(mt.MONO_LAW)]
    plan = monotile_plan(1024, 1024, 1, 12, H100_SXM)
    q_law, threads = mt.law_entry(12)
    assert (plan.q, plan.threads) == (min(q_law, 4), 1024)  # (8+2q)*1026*12 B fits up to q=4
    assert mt.monotile_smem_bytes(plan.band, plan.q, 1024, 1, 12) <= H100_SXM.smem_per_block


@pytest.mark.parametrize("shape,cell_bytes,radius", [
    ((1024, 1024), 12, 1), ((1024, 1024), 8, 1), ((600, 600), 40, 1), ((1024, 1500), 12, 1),
    ((37, 53), 12, 1), ((5, 53), 12, 2), ((300, 1000), 8, 2), ((1030, 64), 4, 1),
])
def test_q_falls_back_to_what_fits(shape, cell_bytes, radius):
    """q is the law's, or the largest smaller one whose deep halo fits the
    CTA's shared memory with q*r <= band; never below 1."""
    plan = monotile_plan(*shape, radius, cell_bytes, H100_SXM)
    q_law, _ = mt.law_entry(cell_bytes)
    budget = mt.smem_budget(H100_SXM, mt.MAX_THREADS // plan.threads)

    def fits(q):
        return q * radius <= plan.band and mt.monotile_smem_bytes(plan.band, q, shape[1], radius, cell_bytes) <= budget

    assert 1 <= plan.q <= q_law
    assert plan.q == 1 or fits(plan.q)
    assert plan.q == q_law or not fits(plan.q + 1)
    if shape == (1024, 1500):
        assert plan.q == min(q_law, 2)  # (8+2q)*1502*12 B: q=2 fits, q=3 does not
    if shape == (37, 53):
        assert plan.q == 1  # one-row bands


def test_admission_is_the_q1_law():
    """monotile_plan admits exactly the grids whose band (ceil(H / SMs) rows,
    at least r) with r halo rows a side fits one block, whatever q it then
    picks, so ``auto`` routes every input as before."""
    for limits in (H100_SXM, DeviceLimits(66, 232448), DeviceLimits(132, 100 * 1024)):
        for cell_bytes in (2, 4, 8, 12, 20, 40):
            for radius in (1, 2):
                for h in (1, 7, 131, 600, 1024, 1030, 1500, 2048, 4096):
                    for w in (16, 53, 600, 1024, 1500, 2048, 5000):
                        band = max(radius, -(-h // limits.sm_count))
                        fits = (band + 2 * radius) * (w + 2 * radius) * cell_bytes <= limits.smem_per_block
                        plan = monotile_plan(h, w, radius, cell_bytes, limits)
                        assert (plan is not None) == fits, (limits, cell_bytes, radius, h, w)
                        if plan is not None:
                            assert plan.n_ctas == -(-h // plan.band) and plan.q * radius <= plan.band


@pytest.mark.parametrize("band,q,radius,run,want", [
    (8, 1, 1, 8, 1.0),
    (8, 2, 1, 8, 24 / 16),   # windows 10, 8: runs of 8 cover 16 + 8 rows
    (8, 4, 1, 8, 56 / 32),   # windows 14, 12, 10, 8
    (8, 4, 1, 1, 44 / 32),   # exact rows: 1 + r(q-1)/band = 1.375
    (5, 2, 1, 1, 12 / 10),   # the probe at 600^2: windows 7, 5
    (4, 4, 1, 8, 40 / 16),   # 512-thread CTAs' 4-row bands
])
def test_mono_work_counts_whole_runs_of_the_narrowing_window(band, q, radius, run, want):
    from stencilstream_tpu_torch.tile_sweep import mono_work

    assert mono_work(band, q, radius, run) == pytest.approx(want)
