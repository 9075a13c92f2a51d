"""Thermal convection on the PyTorch/CUDA port against the JAX package.

Inputs: the tiny inline experiment of ``tests/test_convection.py`` (res 16,
a 48x16 grid) and, for the single-step parity tests, random fields and
random parameters that are not powers of two (a 24x8 grid). The same numpy
values go through the JAX ``reference`` backend (the oracle; float64 under a
scoped ``jax.enable_x64``) and through the port's backends on the CPU:
``reference`` and the plain versions of the three kernels, reached through
``tiling`` (both window modes) and ``monotile``. One pseudo-transient
iteration (full and lean) and one thermal step equal JAX's bit for bit in
float32 and float64: the twins fuse the multiply-adds that XLA fuses
(``models/convection.py``), and the halo value, which the port's kernels
substitute and JAX's do not, never reaches a cell of the grid (the port
runs with a halo of 0.5). Several iterations equal as many one-iteration
JAX calls bit for bit; whole runs, whose JAX calls span nerr iterations
that XLA fuses across, agree within a stated tolerance.
"""

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencilstream_tpu.backends import create_update as j_create_update
from stencilstream_tpu.core import Grid as JGrid
from stencilstream_tpu.core import Params as JParams
from stencilstream_tpu.models import convection as jc

from test_convection import tiny_experiment

from stencilstream_tpu_torch import Params, create_update, interop
from stencilstream_tpu_torch.core.fma import fma, fma_f32, fma_f64
from stencilstream_tpu_torch.models import convection as pc

FIELDS = pc.FIELDS
DTYPES = (np.float32, np.float64)
#: The port's backends on the CPU: the reference, and the plain versions of
#: the three kernels reached through the backends a user calls.
BACKENDS = {
    "reference": ("reference", {}),
    "tile_pass_plain": ("tiling", dict(iters_per_pass=2)),
    "line_cache_pass_plain": ("tiling", dict(window_mode="linecache", strip_rows=8)),
    "monotile_plain": ("monotile", {}),
}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: A non-zero halo: it must never reach a cell of the grid.
HALO = pc.ThermalConvectionCell(**{f: 0.5 for f in FIELDS})


def _random_experiment():
    """res 8 (a 24x8 grid), eta0, DcT and deltaT not powers of two."""
    return dataclasses.replace(tiny_experiment(res=8), eta0=1.37, DcT=0.71, deltaT=1.19)


def _random_fields(shape, dtype, seed) -> dict:
    rng = np.random.default_rng(seed)
    return {f: rng.standard_normal(shape).astype(dtype) for f in FIELDS}


def _random_pt(e, dtype, seed, with_err=True):
    """JAX's pseudo-transient kernel with random parameters; the viscosity's
    temperature coefficient of order 0.1, so that its form shows (the
    experiment's 1e-10 rounds away in float32)."""
    rng = np.random.default_rng(seed)
    k = jc.make_pseudo_transient_kernel(e, dtype, with_err=with_err)
    values = dict(
        roh0_g_alpha=rng.uniform(30, 300), delta_eta_delta_T=rng.uniform(0.05, 0.2),
        dx=rng.uniform(0.05, 0.2), dy=rng.uniform(0.05, 0.2), delta_tau_iter=rng.uniform(0.01, 0.1),
        beta=rng.uniform(0.5, 2), rho=rng.uniform(0.5, 2), dampX=rng.uniform(0.8, 1),
        dampY=rng.uniform(0.8, 1),
    )
    return dataclasses.replace(k, **{n: dtype(v) for n, v in values.items()})


def _random_thermal(e, dtype, seed):
    rng = np.random.default_rng(seed)
    return jc.ThermalSolverKernel(
        nx=e.nx, ny=e.ny, dx=dtype(rng.uniform(0.05, 0.2)), dy=dtype(rng.uniform(0.05, 0.2)),
        dt=dtype(rng.uniform(1e-3, 1e-2)), DcT=dtype(rng.uniform(0.3, 1.5)),
    )


def _jax_step(jtf, fields, n=1) -> dict:
    """``n`` iterations of the JAX ``reference`` backend (float64 under a
    scoped x64 flag)."""
    dtype = fields["T"].dtype
    with jax.enable_x64(dtype == np.float64):
        grid = JGrid.from_numpy(jc.ThermalConvectionCell(**{k: jnp.asarray(v) for k, v in fields.items()}))
        update = j_create_update(
            JParams(transition_function=jtf, halo_value=jc.zero_cell(jnp.dtype(dtype)), n_iterations=n),
            backend="reference",
        )
        out = update(grid).to_numpy()
    return {f: np.asarray(getattr(out, f)) for f in FIELDS}


def _port_step(tf, fields, backend, n=1, halo=HALO) -> dict:
    name, kw = BACKENDS[backend]
    grid = interop.convection_grid(fields, device="cpu")
    update = create_update(Params(transition_function=tf, halo_value=halo, n_iterations=n), backend=name, **kw)
    out = update(grid).to_numpy()
    return {f: getattr(out, f) for f in FIELDS}


def _assert_equal(got: dict, want: dict):
    for f in FIELDS:
        assert got[f].dtype == want[f].dtype, f
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


# -- fma_f64 -----------------------------------------------------------------


def _exact_fma(a, b, c) -> float:
    """``a*b + c`` rounded once to float64: Python's int/int division,
    which ``Fraction.__float__`` uses, rounds correctly (to nearest even)."""
    return float(Fraction(a) * Fraction(b) + Fraction(c))


def _hard_triples(rng, n):
    a = rng.standard_normal(n) * np.exp2(rng.integers(-60, 60, n))
    b = rng.standard_normal(n) * np.exp2(rng.integers(-60, 60, n))
    c = rng.standard_normal(n) * np.exp2(rng.integers(-120, 120, n))
    q = n // 5
    c[:q] = -(a[:q] * b[:q])  # c = -RN(a*b): the result is the product's rounding error
    a[q:2 * q] = 1 + 2.0**-52 * rng.integers(0, 100, q)  # cancellation against 1
    b[q:2 * q] = 1 + 2.0**-52 * rng.integers(0, 100, q)
    c[q:2 * q] = -1.0
    a[2 * q:3 * q] = 1 + 2.0**-30  # a*b lies a quarter ulp from a tie; c moves it onto one
    b[2 * q:3 * q] = 1 + 2.0**-23
    c[2 * q:3 * q] = 2.0**-53 * rng.choice([-1.0, 1.0], q)
    c[3 * q:4 * q] *= 2.0**200  # operands of very different magnitude
    a[4 * q:] *= 2.0**-1000  # subnormal products and results, c of their size
    c[4 * q:] *= 2.0**-1000
    c[4 * q:4 * q + q // 2] = 0.0
    return a, b, c


@pytest.mark.parametrize("seed", [0, 1])
def test_fma_f64_rounds_once(seed):
    """Against ``fractions.Fraction`` on random triples and hard cases:
    ties, cancellation, ``c = -a*b``, operands of very different magnitude,
    and products and results in the subnormal range (which the emulation
    reaches by scaling). The unfused ``a*b + c`` misses many of them."""
    a, b, c = _hard_triples(np.random.default_rng(seed), 5000)
    got = fma_f64(torch.tensor(a), torch.tensor(b), torch.tensor(c)).numpy()
    want = np.array([_exact_fma(*t) for t in zip(a, b, c)])
    np.testing.assert_array_equal(got, want)
    assert ((a * b + c) != want).sum() > 500


def test_fma_f64_takes_a_scalar_and_passes_specials_through():
    a = torch.tensor([3.0, np.inf, 1.0, 1e300])
    c = torch.tensor([1.0, 1.0, np.nan, 0.0])
    got = fma_f64(a, 1e10, c)
    values = got.tolist()
    assert values[0] == 3e10 + 1.0 and values[1] == np.inf and np.isnan(values[2]) and values[3] == np.inf


def test_fma_dispatches_by_dtype():
    x32 = torch.tensor([1.0 + 2.0**-20], dtype=torch.float32)
    assert torch.equal(fma(x32, x32, -x32), fma_f32(x32, x32, -x32))
    x64 = x32.double()
    assert torch.equal(fma(x64, x64, -x64), fma_f64(x64, x64, -x64))
    with pytest.raises(TypeError, match="float32 or float64"):
        fma(torch.tensor([1]), 1, torch.tensor([1]))


# -- the experiment and the initial grid --------------------------------------


@pytest.mark.parametrize("res", [16, 96, 1024])
def test_experiment_derives_what_jax_derives(res):
    j = tiny_experiment(res=res)
    p = interop.convection_experiment(dataclasses.asdict(j))
    assert dataclasses.asdict(p) == dataclasses.asdict(j)
    for name in ("ar", "w_blob", "roh0_g_alpha", "delta_eta_delta_T", "nx", "ny", "dx", "dy", "rho",
                 "dt_diff", "delta_tau_iter", "beta", "dampX", "dampY"):
        assert getattr(p, name) == getattr(j, name), name


def test_experiment_schema_and_its_errors(tmp_path):
    cfg = dataclasses.asdict(tiny_experiment())
    cfg["res"] = 16.0  # ints are cast, as the JAX loader casts them
    path = tmp_path / "exp.json"
    path.write_text(json.dumps(cfg))
    got, want = pc.Experiment.load(str(path)), jc.Experiment.load(str(path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want) and isinstance(got.res, int)
    del cfg["dmp"]
    path.write_text(json.dumps(cfg))
    for loader in (pc.Experiment.load, jc.Experiment.load):
        with pytest.raises(ValueError, match="missing field 'dmp'"):
            loader(str(path))


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
def test_init_grid_equals_jax(dtype):
    e = tiny_experiment()
    got = pc.init_grid(e, dtype, device="cpu").to_numpy()
    with jax.enable_x64(dtype == np.float64):
        want = jc.init_grid(e, dtype).to_numpy()
    for f in FIELDS:
        assert getattr(got, f).dtype == dtype
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)), err_msg=f)


# -- one step against JAX -------------------------------------------------------


@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("with_err", [True, False], ids=["full", "lean"])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
def test_pseudo_transient_step_equals_jax(dtype, with_err, backend):
    e = _random_experiment()
    for seed in (1, 2):
        jtf = _random_pt(e, dtype, seed, with_err)
        fields = _random_fields((e.nx + 1, e.ny + 1), dtype, seed + 100)
        tf = interop.convection_pt_kernel(dataclasses.asdict(jtf))
        assert tf.cuda_op == f"convection_pt{'' if with_err else '_lean'}_{'f64' if dtype == np.float64 else 'f32'}"
        _assert_equal(_port_step(tf, fields, backend), _jax_step(jtf, fields))


@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
def test_thermal_step_equals_jax(dtype, backend):
    e = _random_experiment()
    for seed in (1, 2):
        jtf = _random_thermal(e, dtype, seed)
        fields = _random_fields((e.nx + 1, e.ny + 1), dtype, seed + 200)
        tf = interop.convection_thermal_kernel(dataclasses.asdict(jtf))
        _assert_equal(_port_step(tf, fields, backend), _jax_step(jtf, fields))


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
def test_three_iterations_equal_three_jax_steps(dtype):
    """Several iterations chain the sub-steps' reads of one another's
    writes: n=3 through the tile pass's plain version (a partial pass)
    equals three one-iteration calls of the JAX reference bit for bit. (One
    JAX call of n=3 does not: XLA compiles the call's iterations as one
    program and fuses across them, so it differs from its own three
    one-iteration calls in a few ulps.)"""
    e = _random_experiment()
    jtf = _random_pt(e, dtype, 3)
    fields = want = _random_fields((e.nx + 1, e.ny + 1), dtype, 103)
    for _ in range(3):
        want = _jax_step(jtf, want)
    tf = interop.convection_pt_kernel(dataclasses.asdict(jtf))
    _assert_equal(_port_step(tf, fields, "tile_pass_plain", n=3), want)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
def test_halo_value_never_reaches_the_grid(dtype):
    e = _random_experiment()
    fields = _random_fields((e.nx + 1, e.ny + 1), dtype, 7)
    tf = interop.convection_pt_kernel(dataclasses.asdict(_random_pt(e, dtype, 7)))
    th = interop.convection_thermal_kernel(dataclasses.asdict(_random_thermal(e, dtype, 7)))
    for kernel in (tf, th):
        for backend in ("reference", "tile_pass_plain"):
            _assert_equal(_port_step(kernel, fields, backend, n=2, halo=pc.zero_cell()),
                          _port_step(kernel, fields, backend, n=2, halo=HALO))


#: The invariant fields each functor leaves unread.
UNREAD = {"pt": [], "pt_lean": ["ErrV", "ErrP"],
          "thermal": ["Pt", "tau_xx", "tau_yy", "sigma_xy", "dVxd_tau", "dVyd_tau", "ErrV", "ErrP"]}


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("kind", sorted(UNREAD))
def test_unread_invariant_fields_never_reach_the_grid(dtype, kind):
    """The invariant fields outside ``cuda_invariant_reads``, which the
    kernels' bounds leave out, can hold NaN: every other field comes out
    as it does without them."""
    e = _random_experiment()
    fields = _random_fields((e.nx + 1, e.ny + 1), dtype, 11)
    if kind == "thermal":
        tf = interop.convection_thermal_kernel(dataclasses.asdict(_random_thermal(e, dtype, 11)))
    else:
        tf = interop.convection_pt_kernel(dataclasses.asdict(_random_pt(e, dtype, 11, with_err=kind == "pt")))
    unread = [f for f in FIELDS if f not in tf.cuda_variant and f not in tf.cuda_invariant_reads]
    assert unread == UNREAD[kind]
    poisoned = {**fields, **{f: np.full_like(fields[f], np.nan) for f in unread}}
    for backend in ("reference", "tile_pass_plain"):
        got, want = _port_step(tf, poisoned, backend, n=2), _port_step(tf, fields, backend, n=2)
        _assert_equal({**got, **{f: want[f] for f in unread}}, want)


@pytest.mark.parametrize("dtype,width", [(np.float32, 4), (np.float64, 8)], ids=["float32", "float64"])
def test_traffic_bytes_count_what_each_functor_reads_and_writes(dtype, width):
    """Bytes a cell a pass must read and write: every variant field both
    ways, and the invariant fields the functor reads; a transition function
    that names no reads reads every invariant field."""
    from stencilstream_tpu_torch.backends import cuda_lib
    from stencilstream_tpu_torch.models import hotspot

    e = tiny_experiment()
    cell = pc.init_grid(e, dtype, device="cpu").arrays
    full, lean = pc.make_pseudo_transient_kernel(e, dtype), pc.make_pseudo_transient_kernel(e, dtype, False)
    assert cuda_lib.cell_traffic_bytes(cell, full) == (11 * width, 10 * width)
    assert cuda_lib.cell_traffic_bytes(cell, lean) == (9 * width, 8 * width)
    assert cuda_lib.cell_traffic_bytes(cell, pc.make_thermal_kernel(e, dtype)) == (3 * width, width)
    hot = hotspot.HotspotCell(temp=torch.zeros(4, 4), power=torch.zeros(4, 4))
    assert cuda_lib.cell_traffic_bytes(hot, hotspot.HotspotKernel()) == (8, 4)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
def test_lean_then_full_equals_full_throughout(dtype):
    """nerr - 1 lean iterations and one full one equal nerr full ones on
    every field, the error fields included."""
    e = tiny_experiment()
    nerr = 6
    grid = pc.init_grid(e, dtype, device="cpu")

    def update(with_err, n):
        return create_update(Params(pc.make_pseudo_transient_kernel(e, dtype, with_err), halo_value=HALO,
                                    n_iterations=n), backend="monotile")

    full = update(True, nerr)(grid).to_numpy()
    split = update(True, 1)(update(False, nerr - 1)(grid)).to_numpy()
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(split, f), getattr(full, f), err_msg=f)


def test_grid_of_another_dtype_raises():
    e = tiny_experiment()
    grid = pc.init_grid(e, np.float64, device="cpu")
    for tf in (pc.make_pseudo_transient_kernel(e, np.float32), pc.make_thermal_kernel(e, np.float32)):
        for backend in ("reference", "tiling", "monotile"):
            update = create_update(Params(tf, halo_value=pc.zero_cell()), backend=backend)
            with pytest.raises(TypeError, match="float32 parameters"):
                update(grid)


def test_kernels_name_their_functors():
    e = tiny_experiment()
    for dtype, width in ((np.float32, "f32"), (np.float64, "f64")):
        full = pc.make_pseudo_transient_kernel(e, dtype)
        lean = pc.make_pseudo_transient_kernel(e, dtype, with_err=False)
        thermal = pc.make_thermal_kernel(e, dtype)
        assert (full.cuda_op, lean.cuda_op, thermal.cuda_op) == (
            f"convection_pt_{width}", f"convection_pt_lean_{width}", f"convection_thermal_{width}")
        assert full.cuda_variant == FIELDS[1:] and lean.cuda_variant == FIELDS[1:-2]
        assert thermal.cuda_variant == ("T",)
        assert len(full.cuda_params()) == 14 and full.cuda_params()[:2] == (e.nx, e.ny)
        assert len(thermal.cuda_params()) == 7


def test_scalars_are_computed_in_the_cells_dtype():
    """``1/dx`` in float32 is the float32 quotient, not float64's rounded
    to float32 (they differ for some dx)."""
    dx = np.float32(0.3)
    tf = pc.PseudoTransientKernel(dx=dx, dy=dx, beta=np.float32(3.0), delta_tau_iter=np.float32(0.7))
    k = tf.scalars()
    assert k["inv_dx"] == float(np.float32(1) / dx)
    assert k["dtau_beta"] == float(np.float32(0.7) / np.float32(3.0))
    assert pc.PseudoTransientKernel(dx=np.float64(0.3)).scalars()["inv_dx"] == 1.0 / 0.3


def test_mutated_dt_takes_effect_on_the_next_call():
    e = tiny_experiment()
    grid = pc.init_grid(e, np.float64, device="cpu")
    update = create_update(Params(pc.make_thermal_kernel(e, np.float64, dt=1e-4), halo_value=pc.zero_cell()),
                           backend="tiling")
    first = update(grid).to_numpy().T
    update.get_params().transition_function.dt = np.float64(3e-4)
    assert update.get_params().transition_function.cuda_params()[-1] == 3e-4
    second = update(grid).to_numpy().T
    fresh = create_update(Params(pc.make_thermal_kernel(e, np.float64, dt=3e-4), halo_value=pc.zero_cell()),
                          backend="tiling")(grid).to_numpy().T
    np.testing.assert_array_equal(second, fresh)
    assert not np.array_equal(first, second)


# -- the folded variant ------------------------------------------------------------
# Its parity inputs are 48x16 (res 16): on a 24x8 grid XLA's CPU code for
# JAX's float64 folded kernel leaves the multiply-adds of a few cells in
# rows 7 and 15 unfused (a loop remainder, compiled apart from the
# vectorized body), so JAX disagrees with itself from cell to cell there;
# at res 16 and 32 every cell takes the forms the twin fuses.

PLANES = pc.PLANES


def _folded_experiment():
    """res 16 (a 48x16 grid), eta0, DcT, deltaT and dmp not powers of two."""
    return dataclasses.replace(tiny_experiment(), eta0=1.37, DcT=0.71, deltaT=1.19, dmp=1.3)


def _random_folded_pt(e, dtype, seed, with_err=True):
    """JAX's folded pseudo-transient kernel with random parameters, the
    viscosity's temperature coefficient of order 0.1."""
    rng = np.random.default_rng(seed)
    k = jc.make_folded_pseudo_transient_kernel(e, dtype, with_err=with_err)
    values = dict(roh0_g_alpha=rng.uniform(30, 300), delta_eta_delta_T=rng.uniform(0.05, 0.2),
                  dx=rng.uniform(0.05, 0.2), dy=rng.uniform(0.05, 0.2), rho=rng.uniform(0.5, 2))
    return dataclasses.replace(k, **{n: dtype(v) for n, v in values.items()})


def _folded_backend(backend, dtype) -> tuple:
    """:data:`BACKENDS`' entry, but for the float64 folded cell (264 B of
    shared memory) the tile pass takes its own p, 1: no window of p=2 fits
    one block."""
    name, kw = BACKENDS[backend]
    if dtype == np.float64:
        kw = {k: v for k, v in kw.items() if k != "iters_per_pass"}
    return name, kw


def _jax_folded_steps(jtf, arrays: dict, n) -> dict:
    """``n`` one-iteration calls of JAX's ``reference`` backend on a folded
    grid."""
    dtype = arrays["T"].dtype
    with jax.enable_x64(dtype == np.float64):
        grid = JGrid.from_numpy(jc.FoldedConvectionCell(**{k: jnp.asarray(v) for k, v in arrays.items()}))
        update = j_create_update(
            JParams(transition_function=jtf, halo_value=jc.folded_zero_cell(jnp.dtype(dtype)), n_iterations=1),
            backend="reference",
        )
        for _ in range(n):
            grid = update(grid)
        out = grid.to_numpy()
    return {f: np.asarray(getattr(out, f)) for f in FIELDS + PLANES}


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
def test_folded_planes_and_grid_equal_jax(dtype):
    e = _folded_experiment()
    shape = (e.nx + 1, e.ny + 1)
    got, want = pc.folded_planes(e, shape, dtype), jc.folded_planes(e, shape, dtype)
    assert list(got) == list(want) == list(PLANES)
    for k in PLANES:
        assert got[k].dtype == want[k].dtype and (k in pc.BOOL_PLANES) == (got[k].dtype == bool), k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with jax.enable_x64(dtype == np.float64):
        jgrid = jc.init_folded_grid(e, dtype).to_numpy()
    grid = pc.init_folded_grid(e, dtype, device="cpu").to_numpy()
    for f in FIELDS + PLANES:
        assert getattr(grid, f).dtype == np.asarray(getattr(jgrid, f)).dtype, f
        np.testing.assert_array_equal(getattr(grid, f), np.asarray(getattr(jgrid, f)), err_msg=f)


@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("with_err", [True, False], ids=["full", "lean"])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
def test_folded_steps_equal_jax_bit_for_bit(dtype, with_err, backend):
    """Three folded iterations in one call of the port (``reference`` or a
    kernel's plain version) equal three one-iteration calls of JAX's folded
    twin bit for bit, on random fields and parameters, every field and
    plane; the port's halo is 0.5 (True in the bool planes)."""
    e = _folded_experiment()
    shape = (e.nx + 1, e.ny + 1)
    arrays = {**_random_fields(shape, dtype, 21), **jc.folded_planes(e, shape, dtype)}
    jtf = _random_folded_pt(e, dtype, 22, with_err)
    want = _jax_folded_steps(jtf, arrays, 3)
    tf = interop.convection_folded_pt_kernel(dataclasses.asdict(jtf))
    assert tf.with_err is with_err and tf.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
    name, kw = _folded_backend(backend, dtype)
    halo = pc.FoldedConvectionCell(**{f: 0.5 for f in FIELDS + PLANES})
    update = create_update(Params(transition_function=tf, halo_value=halo, n_iterations=3), backend=name, **kw)
    out = update(interop.convection_folded_grid(arrays, device="cpu")).to_numpy()
    for f in FIELDS + PLANES:
        assert getattr(out, f).dtype == want[f].dtype, f
        np.testing.assert_array_equal(getattr(out, f), want[f], err_msg=f)


@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
def test_folded_equals_straight_bit_for_bit(dtype, backend):
    """Seven iterations of the folded kernel (full, and six lean then one
    full) on the tiny experiment's initial grid equal seven of the straight
    kernel bit for bit, on every physics field (after
    ``tests/test_convection.py``'s TestFoldedKernel)."""
    e = tiny_experiment()
    name, kw = _folded_backend(backend, dtype)

    def update(tf, n, halo):
        return create_update(Params(transition_function=tf, halo_value=halo, n_iterations=n), backend=name, **kw)

    straight = update(pc.make_pseudo_transient_kernel(e, dtype), 7, pc.zero_cell())(
        pc.init_grid(e, dtype, device="cpu")).to_numpy()
    grid = pc.init_folded_grid(e, dtype, device="cpu")
    halo = pc.folded_zero_cell()
    full = update(pc.make_folded_pseudo_transient_kernel(e, dtype), 7, halo)(grid).to_numpy()
    lean = update(pc.make_folded_pseudo_transient_kernel(e, dtype, with_err=False), 6, halo)(grid)
    split = update(pc.make_folded_pseudo_transient_kernel(e, dtype), 1, halo)(lean).to_numpy()
    assert np.abs(straight.Vy).max() > 0
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(full, f), getattr(straight, f), err_msg=f)
        np.testing.assert_array_equal(getattr(split, f), getattr(straight, f), err_msg=f)


def test_folded_kernels_name_their_functors():
    e = tiny_experiment()
    for dtype, width in ((np.float32, "f32"), (np.float64, "f64")):
        full = pc.make_folded_pseudo_transient_kernel(e, dtype)
        lean = pc.make_folded_pseudo_transient_kernel(e, dtype, with_err=False)
        assert (full.cuda_op, lean.cuda_op) == (f"convection_folded_pt_{width}", f"convection_folded_pt_lean_{width}")
        assert full.cuda_variant == FIELDS[1:] and lean.cuda_variant == FIELDS[1:-2]
        assert full.cuda_invariant_reads == ("T", *PLANES) and "m_v" not in lean.cuda_invariant_reads
        assert len(full.cuda_params()) == 8


# -- whole runs -----------------------------------------------------------------


_JAX_RUNS = {}


def _jax_run(dtype):
    if dtype not in _JAX_RUNS:
        grid, info = jc.run(tiny_experiment(), backend="reference", dtype=dtype, verbose=False)
        _JAX_RUNS[dtype] = (grid.to_numpy(), info["stats"])
    return _JAX_RUNS[dtype]


#: ``run`` against JAX's ``run``, per dtype: (each field's largest
#: difference over the field's largest magnitude, the relative difference
#: of errV, errP and dt). The runs do not meet bit for bit, since JAX's
#: calls of nerr iterations fuse across iterations (see
#: test_three_iterations_equal_three_jax_steps); on the tiny experiment
#: (750 iterations) the fields differ by up to 1.9e-4 of their magnitude in
#: float32 (dVxd_tau) and 4.6e-13 in float64, errV and dt by 7.2e-8 in
#: float32 and not at all in float64.
RUN_TOLERANCE = {np.float32: (1e-3, 1e-6), np.float64: (1e-11, 1e-13)}


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
def test_run_equals_jax_run(dtype):
    """``run`` through ``auto`` (the resident grid's plain version here, with
    the lean/full split) against JAX's ``run(backend="reference")``: the
    same iterations per timestep, and errV, errP, dt and the final fields
    within :data:`RUN_TOLERANCE`."""
    field_tol, stat_tol = RUN_TOLERANCE[dtype]
    want_grid, want_stats = _jax_run(dtype)
    grid, info = pc.run(tiny_experiment(), backend="auto", dtype=dtype, verbose=False, device="cpu")
    assert info["lean_update"] is not None and info["pt_update"].resolved_backend == "monotile"
    assert [s["iters"] for s in info["stats"]] == [s["iters"] for s in want_stats]
    for got, want in zip(info["stats"], want_stats):
        for key in ("errV", "errP", "dt"):
            assert abs(got[key] - want[key]) <= stat_tol * abs(want[key]), (key, got, want)
    out = grid.to_numpy()
    for f in FIELDS:
        want = np.asarray(getattr(want_grid, f))
        assert getattr(out, f).dtype == dtype
        assert np.abs(getattr(out, f) - want).max() <= field_tol * np.abs(want).max(), f


_JAX_FOLDED_RUNS = {}


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
def test_folded_run_equals_jax_folded_run(dtype):
    """``run(folded=True)`` through ``auto`` against JAX's ``run(folded=True,
    backend="monotile")`` (its resident-grid kernel in interpret mode; JAX
    runs float64 on ``reference``, straight): the same iterations per
    timestep, and errV, errP, dt and the physics fields within
    :data:`RUN_TOLERANCE`; the planes come back as they went in."""
    field_tol, stat_tol = RUN_TOLERANCE[dtype]
    if dtype not in _JAX_FOLDED_RUNS:
        with pytest.warns(UserWarning) if dtype == np.float64 else contextlib.nullcontext():
            grid, info = jc.run(tiny_experiment(), backend="monotile", dtype=dtype, verbose=False, folded=True)
        _JAX_FOLDED_RUNS[dtype] = (grid.to_numpy(), info["stats"])
    want_grid, want_stats = _JAX_FOLDED_RUNS[dtype]
    grid, info = pc.run(tiny_experiment(), backend="auto", dtype=dtype, verbose=False, folded=True, device="cpu")
    assert isinstance(info["pt_update"].transition_function, pc.FoldedPseudoTransientKernel)
    assert info["lean_update"] is not None and info["pt_update"].resolved_backend == "monotile"
    assert [s["iters"] for s in info["stats"]] == [s["iters"] for s in want_stats]
    for got, want in zip(info["stats"], want_stats):
        for key in ("errV", "errP", "dt"):
            assert abs(got[key] - want[key]) <= stat_tol * abs(want[key]), (key, got, want)
    out = grid.to_numpy()
    for f in FIELDS:
        want = np.asarray(getattr(want_grid, f))
        assert getattr(out, f).dtype == dtype
        assert np.abs(getattr(out, f) - want).max() <= field_tol * np.abs(want).max(), f
    planes = pc.folded_planes(tiny_experiment(), grid.shape, dtype)
    for f in PLANES:
        np.testing.assert_array_equal(getattr(out, f), planes[f], err_msg=f)


def test_folded_run_through_every_backend_is_the_straight_run():
    """``run(folded=True)`` on every backend (the three kernels' plain
    versions and ``reference``) gives the straight ``reference`` run bit for
    bit: statistics and physics fields."""
    e = tiny_experiment(nt=2, iterMax=100)
    want, want_info = pc.run(e, backend="reference", dtype=np.float64, verbose=False, device="cpu")
    for backend, kw in (("reference", {}), ("tiling", {}), ("tiling", {"window_mode": "linecache", "strip_rows": 8}),
                        ("monotile", {})):
        got, info = pc.run(e, backend=backend, dtype=np.float64, verbose=False, folded=True, device="cpu", **kw)
        assert isinstance(got.arrays, pc.FoldedConvectionCell)
        assert info["stats"] == want_info["stats"], backend
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(got.to_numpy(), f), getattr(want.to_numpy(), f), err_msg=f)


def test_run_through_every_backend_is_one_run():
    """The lean/full split and the three kernels' plain versions give the
    ``reference`` backend's run bit for bit."""
    e = tiny_experiment(nt=2, iterMax=100)
    want, want_info = pc.run(e, backend="reference", dtype=np.float64, verbose=False, device="cpu")
    for backend, kw in (("tiling", {}), ("tiling", {"window_mode": "linecache", "strip_rows": 8}), ("monotile", {})):
        got, info = pc.run(e, backend=backend, dtype=np.float64, verbose=False, device="cpu", **kw)
        assert info["stats"] == want_info["stats"], backend
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(got.to_numpy(), f), getattr(want.to_numpy(), f), err_msg=f)


def test_reference_run_has_no_lean_split():
    grid, info = pc.run(tiny_experiment(nt=1, iterMax=50), backend="reference", verbose=False, device="cpu")
    assert info["lean_update"] is None and info["pt_update"].params.n_iterations == 50
    assert [s["iters"] for s in info["stats"]] == [50]


def test_cli_end_to_end(tmp_path):
    """``python -m stencilstream_tpu_torch.models.convection exp.json out
    --device cpu --dtype float64``: the JAX CLI's report lines and its exit
    codes, and one CSV frame of the (nx, ny) T region per timestep, equal as
    text to the library run's and within 1e-9 of JAX's; with ``--folded``
    the same frames, byte for byte."""
    cfg = dataclasses.asdict(tiny_experiment(nt=2, iterMax=100))
    (tmp_path / "exp.json").write_text(json.dumps(cfg))
    dirs = {k: tmp_path / k for k in ("cli", "lib", "jax")}
    for d in dirs.values():
        d.mkdir()
    cmd = [sys.executable, "-m", "stencilstream_tpu_torch.models.convection"]
    proc = subprocess.run([*cmd, str(tmp_path / "exp.json"), str(dirs["cli"]), "--device", "cpu", "--dtype", "float64"],
                          capture_output=True, text=True, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "it = 2 (iter = 100" in proc.stdout and "Of which transient computation time" in proc.stdout
    pc.run(pc.Experiment(**cfg), out_dir=str(dirs["lib"]), dtype=np.float64, verbose=False, device="cpu")
    jc.run(jc.Experiment(**cfg), out_dir=str(dirs["jax"]), backend="reference", dtype=np.float64, verbose=False)
    for it in (1, 2):
        text = (dirs["cli"] / f"{it}.csv").read_text()
        assert text == (dirs["lib"] / f"{it}.csv").read_text()
        data = np.loadtxt(dirs["cli"] / f"{it}.csv", delimiter=",")
        assert data.shape == (cfg["res"] * 3 - 1, cfg["res"] - 1)
        np.testing.assert_allclose(data, np.loadtxt(dirs["jax"] / f"{it}.csv", delimiter=","), rtol=1e-9, atol=1e-12)
    folded = tmp_path / "folded"
    folded.mkdir()
    proc = subprocess.run([*cmd, str(tmp_path / "exp.json"), str(folded), "--device", "cpu", "--dtype", "float64",
                           "--folded"], capture_output=True, text=True, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "it = 2 (iter = 100" in proc.stdout
    for it in (1, 2):
        assert (folded / f"{it}.csv").read_text() == (dirs["cli"] / f"{it}.csv").read_text()
    for args, message in (([str(tmp_path / "none.json"), str(dirs["cli"])], "experiment file does not exist"),
                          ([str(tmp_path / "exp.json"), str(tmp_path / "none")], "output directory does not exist")):
        proc = subprocess.run([*cmd, *args, "--device", "cpu"], capture_output=True, text=True, cwd=REPO, timeout=300)
        assert proc.returncode == 1 and message in proc.stderr


# -- interop ----------------------------------------------------------------------


def test_interop_carries_kernels_and_grids():
    e = _random_experiment()
    for dtype in DTYPES:
        jtf = _random_pt(e, dtype, 4, with_err=False)
        tf = interop.convection_pt_kernel(dataclasses.asdict(jtf))
        assert isinstance(tf, pc.PseudoTransientKernel) and tf.with_err is False
        assert {f.name: getattr(tf, f.name) for f in dataclasses.fields(tf)} == dataclasses.asdict(jtf)
        assert tf.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
        th = interop.convection_thermal_kernel(dataclasses.asdict(_random_thermal(e, dtype, 4)))
        assert isinstance(th, pc.ThermalSolverKernel) and th.dtype == tf.dtype
        fields = _random_fields((4, 5), dtype, 4)
        grid = interop.convection_grid(jc.ThermalConvectionCell(**fields), device="cpu")
        assert grid.shape == (4, 5) and isinstance(grid.arrays, pc.ThermalConvectionCell)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(grid.to_numpy(), f), fields[f])


@pytest.mark.parametrize("backend,kw,kernel", [
    ("tiling", {}, "tile_pass"), ("tiling", {"window_mode": "linecache"}, "line_cache"), ("monotile", {}, "monotile"),
])
def test_kernel_launch_repeats_one_launch_of_each_update(backend, kw, kernel):
    """``trace_cells.kernel_launch`` names the kernel each of a run's
    updates resolved to and repeats one of its launches at its geometry
    (on the CPU, the plain version), equal to the plain version's."""
    from stencilstream_tpu_torch.trace_cells import convection_updates, kernel_launch

    e = dataclasses.replace(tiny_experiment(), iterMax=6, nerr=3, nt=1)
    out, info = pc.run(e, backend=backend, verbose=False, device="cpu", **kw)
    for update in convection_updates(info):
        launched, fn, plain, what, n = kernel_launch(update, out.arrays, pc.zero_cell())
        assert launched == kernel and n >= 1, what
        got, want = fn(), plain()
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(got, f).numpy(), getattr(want, f).numpy(), err_msg=f)
