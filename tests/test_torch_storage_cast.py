"""Narrow cell storage (``backends/storage_cast.py``) on the PyTorch/CUDA port
against the JAX package.

The same numpy inputs go through JAX's ``CastStorageKernel`` and
``cast_storage`` (JAX on the CPU, its ``reference`` backend the oracle, its
``tiling`` and ``monotile`` Pallas kernels in interpret mode as
``tests/test_storage_cast.py`` runs them) and through the port's, on the
reference backend and on the plain versions of the port's three kernels.

Both packages upcast every stored tap to float32, compute in float32 with
the same association and fused multiply-adds as the float32 apps (see
``test_torch_jacobi.py``, ``test_torch_hotspot.py``, ``test_torch_fdtd.py``)
and round each result back to the stored dtype to nearest even; float8
e4m3fn overflow (beyond 464) is NaN on both sides, where PyTorch's own cast
would saturate to 448. So the stored bits agree exactly after one iteration
of each narrow functor; NaN payloads are not compared (JAX's bfloat16 NaN is
0x7fc0, the port's may keep another payload), NaN positions are.

One exception is built in: on bfloat16 cells XLA leaves Jacobi5's second
multiply-add unfused, which it fuses in float32, and the port does the same
there (``models/jacobi.py``, ``csrc/ops/jacobi.cuh``). Two are stated where
they occur: whole Jacobi5 runs in float8 and JAX's interpreted Pallas
kernels on bfloat16, where XLA contracts the multiply-adds yet otherwise,
are held within one ulp of the stored dtype at the field's magnitude.
FDTD carries JAX's amplitudes across as a stream (``interop.StreamTDV``), as
``test_torch_fdtd.py`` does.
"""

import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from stencilstream_tpu.backends import create_update as j_create_update
from stencilstream_tpu.backends.storage_cast import CastStorageKernel as JCast
from stencilstream_tpu.backends.storage_cast import cast_storage as j_cast_storage
from stencilstream_tpu.core import Grid as JGrid
from stencilstream_tpu.core import Params as JParams
from stencilstream_tpu.models import fdtd as jf
from stencilstream_tpu.models import hotspot as jhs
from stencilstream_tpu.models import jacobi as jj
from stencilstream_tpu.tdv import _batched_tdv

from test_fdtd import tiny_config

from stencilstream_tpu_torch import Grid, Params, create_update, interop
from stencilstream_tpu_torch.backends import cuda_lib
from stencilstream_tpu_torch.backends.storage_cast import CastStorageKernel, cast_storage
from stencilstream_tpu_torch.core.cell import E4M3_OVERFLOW, cell_leaves, to_storage
from stencilstream_tpu_torch.models import fdtd as pf
from stencilstream_tpu_torch.models import hotspot as hs

#: JAX's and the port's names of the narrow dtypes.
DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16), "float8_e4m3fn": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}
#: The port's backends on the CPU: the reference and the plain versions of
#: the three kernels, through the backends a user calls.
BACKENDS = {
    "reference": ("reference", {}),
    "tile_pass_plain": ("tiling", dict(iters_per_pass=3)),
    "line_cache_pass_plain": ("tiling", dict(iters_per_pass=3, window_mode="linecache", strip_rows=8)),
    "monotile_plain": ("monotile", {}),
}
JACOBI5 = [0.15, 0.2, 0.25, 0.1, 0.3]


def _on(backend: str) -> dict:
    """The port's backend and options for a :data:`BACKENDS` entry."""
    name, kw = BACKENDS[backend]
    return dict(backend=name, **kw)


def _bits(a) -> np.ndarray:
    """The stored bits of a narrow numpy array (JAX's ml_dtypes array, or
    the port's ``to_numpy()`` bits) as float32 values, NaN where NaN."""
    a = np.asarray(a)
    if a.dtype.name in DTYPES:
        return a.astype(np.float32)
    narrow = ml_dtypes.bfloat16 if a.dtype == np.uint16 else ml_dtypes.float8_e4m3fn
    return a.view(narrow).astype(np.float32)


def _assert_same(got, want):
    """Field by field: the same stored values, NaN where the other is NaN."""
    for g, w in zip(cell_leaves(got), cell_leaves(want)):
        np.testing.assert_array_equal(_bits(g), _bits(w))


#: Significand bits after the point: one ulp at magnitude m is 2^(floor(log2 m) - bits).
MANTISSA_BITS = {"bfloat16": 7, "float8_e4m3fn": 3}


def _assert_within_one_ulp(got, want, storage):
    """Field by field: NaN where the other is NaN, and elsewhere within one
    ulp of the stored dtype at the field's magnitude (its largest value)."""
    for g, w in zip(cell_leaves(got), cell_leaves(want)):
        g, w = _bits(g), _bits(w)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        magnitude = np.nanmax(np.abs(w))
        ulp = 2.0 ** (np.floor(np.log2(magnitude)) - MANTISSA_BITS[storage])
        np.testing.assert_allclose(np.nan_to_num(g), np.nan_to_num(w), rtol=0, atol=ulp)


def _jax(jtf, arrays, storage, n, halo, backend="reference", offset=0, tdv=None, **kw):
    """``n`` iterations of JAX's wrapped ``jtf`` on ``arrays`` stored as
    ``storage``; the output's numpy cell."""
    jdtype = DTYPES[storage][0]
    params = JParams(transition_function=JCast(jtf, jdtype), halo_value=halo, n_iterations=n,
                     iteration_offset=offset, **({"tdv_strategy": tdv} if tdv else {}))
    update = j_create_update(params, backend=backend, **kw)
    update.fallback_to_reference = False
    return update(j_cast_storage(JGrid.from_numpy(arrays), jdtype)).to_numpy()


def _port(tf, arrays, storage, n, halo, backend="reference", offset=0, tdv=None, **kw):
    """The port's side of :func:`_jax`, its inputs cast from the same numpy
    float32 cell."""
    params = Params(interop.cast_storage_kernel(tf, storage), halo_value=halo, n_iterations=n,
                    iteration_offset=offset, **({"tdv_strategy": tdv} if tdv else {}))
    update = create_update(params, backend=backend, **kw)
    grid = cast_storage(Grid.from_numpy(arrays, device="cpu"), DTYPES[storage][1])
    return update(grid).to_numpy()


def _jacobi(shape, seed, scale=1.0):
    x = (np.random.default_rng(seed).random(shape) * scale).astype(np.float32)
    jtf = jj.make_kernel("jacobi5_general", JACOBI5)
    return jtf, interop.jacobi_kernel("jacobi5_general", jtf), x


def _hotspot(shape, seed):
    """Random temperatures and power, and strong coefficients: an
    iteration moves temperatures by ~1, more than a bfloat16 ulp at 80
    (0.5), where the derived ones would leave the stored grid unchanged."""
    rng = np.random.default_rng(seed)
    cell = jhs.HotspotCell(temp=rng.uniform(70, 90, shape).astype(np.float32),
                           power=rng.uniform(0, 1e-3, shape).astype(np.float32))
    jtf = dataclasses.replace(jhs.derive_coefficients(*shape), Rx_1=np.float32(0.1), Ry_1=np.float32(0.1),
                              Rz_1=np.float32(0.05), Cap_1=np.float32(0.5))
    return jtf, interop.hotspot_kernel(dataclasses.asdict(jtf)), cell


def _fdtd(offset, n, seed):
    """FDTD's tiny config with the coef resolver, random fields and random
    coefficients, a disk source of radius 3 cells; JAX's amplitudes for
    iterations offset..offset+n-1."""
    p = jf.Parameters.from_json(tiny_config(source_radius=30e-9))
    jres = jf.CoefResolver(p)
    jtf = jf.make_kernel(p, jres)
    arrays = jf.init_grid(p, jres).to_numpy()
    rng = np.random.default_rng(seed)
    shape = arrays.ex.shape
    fields = {f: rng.standard_normal(shape).astype(np.float32) for f in ("ex", "ey", "hz", "hz_sum")}
    fields.update({f: rng.uniform(0.5 if f in ("ca", "da") else 0.0, 1.0 if f in ("ca", "da") else 0.5,
                                  shape).astype(np.float32) for f in ("ca", "cb", "da", "db")})
    arrays = dataclasses.replace(arrays, **fields)
    amplitudes = np.asarray(_batched_tdv(jtf, jnp.arange(n) + offset))
    tf = interop.fdtd_kernel("coef", {f.name: getattr(jtf, f.name) for f in dataclasses.fields(jtf)})
    return jtf, tf, arrays, amplitudes


# -- one iteration, bit for bit -------------------------------------------------


@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("storage", list(DTYPES))
def test_jacobi5_one_iteration_equals_jax(storage, backend):
    """A random 24x40 grid at halo 0 (at a non-zero halo XLA folds the halo
    taps' products into constants, so float32 edge cells differ by an ulp,
    which can carry across a narrow rounding: ``test_torch_jacobi.py``)."""
    jtf, tf, x = _jacobi((24, 40), 1)
    want = _jax(jtf, x, storage, 1, jnp.float32(0.0))
    _assert_same(_port(tf, x, storage, 1, 0.0, **_on(backend)), want)


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_hotspot_one_iteration_equals_jax(backend):
    """A random 24x40 grid, halo 0, bfloat16 (temperatures in [70, 90] keep
    2 or 3 significant bits after the point)."""
    jtf, tf, cell = _hotspot((24, 40), 2)
    want = _jax(jtf, cell, "bfloat16", 1, jhs.HotspotCell(temp=jnp.float32(0), power=jnp.float32(0)))
    got = _port(tf, cell, "bfloat16", 1, hs.HotspotCell(temp=0.0, power=0.0), **_on(backend))
    _assert_same(got, want)
    assert not np.array_equal(_bits(got.temp), _bits(cell.temp.astype(ml_dtypes.bfloat16)))


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_fdtd_coef_one_iteration_equals_jax(backend):
    """Random fields and coefficients, the disk source on, one iteration at
    12840 (amplitude near 1), bfloat16, JAX's amplitude carried across."""
    jtf, tf, arrays, amps = _fdtd(12840, 1, 3)
    assert np.abs(amps).max() > 0.9
    want = _jax(jtf, arrays, "bfloat16", 1, jf.CoefResolver.halo_cell(), offset=12840,
                tdv="precompute_on_host")
    got = _port(tf, arrays, "bfloat16", 1, pf.CoefResolver.halo_cell(), **_on(backend), offset=12840,
                tdv=interop.StreamTDV(amps, 12840))
    _assert_same(got, want)


# -- whole runs -------------------------------------------------------------------


@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("storage", list(DTYPES))
def test_jacobi5_run_equals_jax(storage, backend):
    """n=8 at halo 0 (where the float32 paths agree bit for bit): bfloat16
    bit for bit. In float8 e4m3 within one e4m3 ulp of the field's
    magnitude (0.125 at values up to 1): there XLA places the fused
    multiply-adds of a call by the call's length (a call of one iteration
    fuses all four, which the port does; a call of two leaves the first
    unfused), so a few cells of a whole run round to the neighbouring
    value."""
    jtf, tf, x = _jacobi((24, 40), 4)
    want = _jax(jtf, x, storage, 8, jnp.float32(0.0))
    got = _port(tf, x, storage, 8, 0.0, **_on(backend))
    if storage == "bfloat16":
        _assert_same(got, want)
    else:
        _assert_within_one_ulp(got, want, storage)


@pytest.mark.parametrize("jax_backend,jax_kw", [("tiling", dict(strip_rows=32, iters_per_pass=2)),
                                                ("monotile", dict(unroll=2))])
def test_jacobi5_run_equals_jax_kernels(jax_backend, jax_kw):
    """JAX's own Pallas kernels (interpret mode) on bfloat16, n=4, against
    the port's tile pass's plain version: within one bfloat16 ulp of the
    field's magnitude (2^-8 at values up to 1). XLA contracts the
    interpreted kernel's multiply-adds on bfloat16 cells in yet another
    way than the reference backend's (about 1% of the cells round to the
    neighbouring value; in float32 the two agree bit for bit,
    ``test_torch_jacobi.py``)."""
    jtf, tf, x = _jacobi((32, 128), 5)
    want = _jax(jtf, x, "bfloat16", 4, jnp.float32(0.0), jax_backend, **jax_kw)
    _assert_within_one_ulp(_port(tf, x, "bfloat16", 4, 0.0, "tiling", iters_per_pass=2), want, "bfloat16")


@pytest.mark.parametrize("backend", ["reference", "tile_pass_plain"])
def test_hotspot_run_equals_jax(backend):
    jtf, tf, cell = _hotspot((24, 40), 6)
    want = _jax(jtf, cell, "bfloat16", 6, jhs.HotspotCell(temp=jnp.float32(0), power=jnp.float32(0)))
    _assert_same(_port(tf, cell, "bfloat16", 6, hs.HotspotCell(temp=0.0, power=0.0), **_on(backend)), want)


@pytest.mark.parametrize("backend", ["reference", "line_cache_pass_plain"])
def test_fdtd_coef_run_equals_jax(backend):
    """Six iterations from 12840."""
    jtf, tf, arrays, amps = _fdtd(12840, 6, 7)
    want = _jax(jtf, arrays, "bfloat16", 6, jf.CoefResolver.halo_cell(), offset=12840,
                tdv="precompute_on_host")
    got = _port(tf, arrays, "bfloat16", 6, pf.CoefResolver.halo_cell(), **_on(backend), offset=12840,
                tdv=interop.StreamTDV(amps, 12840))
    _assert_same(got, want)


# -- float8 overflow -----------------------------------------------------------------


def test_float8_overflow_is_nan_as_in_jax():
    """Jacobi5 with coefficients summing to 2.5 on values in [20, 260]:
    some results exceed 464 and are NaN on both sides (PyTorch's own cast
    would give 448), and NaN spreads the same way on the next steps."""
    x = np.random.default_rng(8).uniform(20, 260, (24, 40)).astype(np.float32)
    jtf = jj.make_kernel("jacobi5_general", [0.5] * 5)
    tf = interop.jacobi_kernel("jacobi5_general", jtf)
    for n in (1, 3):
        want = _jax(jtf, x, "float8_e4m3fn", n, jnp.float32(1.0))
        got = _port(tf, x, "float8_e4m3fn", n, 1.0)
        _assert_same(got, want)
        if n == 1:
            assert 0 < np.isnan(_bits(got)).sum() < got.size
    assert torch.tensor([500.0]).to(torch.float8_e4m3fn).item() == 448.0  # what the port does not do


def test_to_storage_rounds_as_jax():
    """Random float32 values over 1e-12..1e4 in magnitude, subnormals and
    the edges of e4m3's range (448, 464, 465, infinities): the port's cast
    gives JAX's values in both dtypes."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal(20000).astype(np.float32) * (10.0 ** rng.uniform(-12, 4, 20000)).astype(np.float32)
    edges = [0.0, -0.0, 448, 464, 464.0001, 465, -465, 480, 1e30, np.inf, -np.inf, 2 ** -9, 2 ** -10,
             3 * 2 ** -11, 1e-40, np.nan]
    x = np.concatenate([x, np.array(edges, np.float32)])
    for storage, (jdtype, dtype) in DTYPES.items():
        want = np.asarray(jnp.asarray(x).astype(jdtype)).astype(np.float32)
        got = to_storage(torch.from_numpy(x), dtype).float().numpy()
        np.testing.assert_array_equal(got, want, err_msg=storage)
    assert E4M3_OVERFLOW == 464.0


# -- the wrapper ------------------------------------------------------------------------


def test_cast_storage_leaves_int_and_bool_fields_alone():
    arrays = {"a": torch.ones(4, 4), "i": torch.ones(4, 4, dtype=torch.int32), "b": torch.ones(4, 4, dtype=torch.bool)}
    from stencilstream_tpu_torch.core.cell import cell_type

    @cell_type
    class Mixed:
        a: torch.Tensor
        i: torch.Tensor
        b: torch.Tensor

    for dtype in (torch.bfloat16, torch.float8_e4m3fn):
        out = cast_storage(Grid(Mixed(**arrays)), dtype)
        assert isinstance(out, Grid)
        assert (out.arrays.a.dtype, out.arrays.i.dtype, out.arrays.b.dtype) == (dtype, torch.int32, torch.bool)
        assert out.arrays.i is arrays["i"] and out.arrays.b is arrays["b"]
    assert cast_storage(torch.ones(2, 2)).dtype == torch.bfloat16


def test_contract_and_device_functor_pass_through():
    """Radius, sub-iterations, the time-dependent value, handles_boundary
    and the device functor's attributes are the inner function's;
    cuda_storage names the storage dtype."""
    jtf, tf, _, _ = _fdtd(0, 1, 0)
    wrapped = interop.cast_storage_kernel(tf)
    jwrapped = JCast(jtf)
    assert (wrapped.stencil_radius, wrapped.n_subiterations) == (tf.stencil_radius, tf.n_subiterations) == (
        jwrapped.stencil_radius, jwrapped.n_subiterations)
    assert wrapped.handles_boundary == jwrapped.handles_boundary
    for i in (0, 3, 12840):
        assert float(wrapped.get_time_dependent_value(i)) == float(tf.get_time_dependent_value(i))
    for name in ("cuda_op", "cuda_variant", "cuda_tdv", "n_operations"):
        assert getattr(wrapped, name) == getattr(tf, name), name
    assert wrapped.cuda_params() == tf.cuda_params()
    assert wrapped.cuda_storage == torch.bfloat16
    assert cuda_lib.require_device_op(wrapped) == "fdtd_coef__bf16"
    assert interop.cast_storage_kernel(tf, "float8_e4m3fn").cuda_storage == torch.float8_e4m3fn
    assert not hasattr(interop.cast_storage_kernel(hs.HotspotKernel()), "cuda_tdv")


def test_a_passed_through_field_stays_the_stored_tensor():
    """HotSpot returns the centre's power unchanged: the wrapper gives back
    the stored bfloat16 tensor, not an upcast copy (the JAX package keeps
    such a field loop-invariant so)."""
    from stencilstream_tpu_torch.backends.reference import single_subiteration

    _, tf, cell = _hotspot((6, 8), 10)
    grid = cast_storage(interop.hotspot_grid(cell, device="cpu"))
    halo = hs.HotspotCell(temp=0.0, power=0.0)
    out = single_subiteration(grid.arrays, CastStorageKernel(tf), halo, 0, 0, None, radius=1)
    assert out.power is grid.arrays.power and out.temp.dtype == torch.bfloat16


def test_a_cell_that_mixes_storage_types_has_no_kernel():
    """FDTD's lut cell stored narrow keeps its int32 ring index beside
    bfloat16 fields; a functor has one element type, so the lookup refuses
    it, naming the field and both dtypes."""
    p = pf.Parameters.from_json(tiny_config())
    res = pf.LUTResolver(p)
    cell = cast_storage(pf.init_grid(p, res, device="cpu")).arrays
    leaves = cell_leaves(cell)
    names = tuple(f.name for f in dataclasses.fields(cell))
    with pytest.raises(TypeError, match="'index' is torch.int32"):
        cuda_lib.check_field_dtypes("fdtd_coef__bf16", torch.bfloat16, names, leaves, leaves)


@pytest.mark.parametrize("storage", list(DTYPES))
def test_narrow_numpy_grids_cross_both_ways(storage):
    """JAX's narrow arrays come in through their bits and go back as bits."""
    jdtype, dtype = DTYPES[storage]
    x = np.random.default_rng(11).standard_normal((5, 7)).astype(np.float32) * 10
    jarr = np.asarray(j_cast_storage(JGrid.from_numpy(x), jdtype).to_numpy())
    grid = interop.grid_from_numpy(None, jarr, device="cpu")
    assert grid.arrays.dtype == dtype
    np.testing.assert_array_equal(grid.arrays.float().numpy(), jarr.astype(np.float32))
    back = grid.to_numpy()
    assert back.dtype == (np.uint16 if storage == "bfloat16" else np.uint8)
    np.testing.assert_array_equal(back, jarr.view(back.dtype))
    cell = interop.hotspot_grid({"temp": jarr, "power": jarr}, device="cpu")
    assert cell.arrays.temp.dtype == cell.arrays.power.dtype == dtype
