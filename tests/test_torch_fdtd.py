"""FDTD on the PyTorch/CUDA port against the JAX package.

Inputs come from ``tests/test_fdtd.py::tiny_config`` only (a 20^2 grid, one
dielectric ring), made into both packages' objects from the same numpy
values through ``stencilstream_tpu_torch.interop``; JAX runs on the CPU and
its ``reference`` backend is the oracle.

The source amplitude, FDTD's time-dependent value (TDV), is
``cos(w t) exp(-((t - t0)/tau)^2)`` in float32. XLA's float32 ``cos`` is
inaccurate at large arguments (w t reaches ~1131 rad over a 15 tau run), so
the port does not try to copy its error: the port's amplitudes are held
within 2 ulps of a float64 evaluation of the same float32 arguments, and
within 4e-5 of JAX's (the size of XLA's error). The field comparisons then
carry JAX's own amplitudes across as a stream, as they carry the grid
across, and hold the port's fields bit-equal to JAX's: the port keeps the
JAX package's float32 association and fuses the multiply-adds that XLA
fuses there.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencilstream_tpu.backends import create_update as j_create_update
from stencilstream_tpu.core import Grid as JGrid
from stencilstream_tpu.core import Params as JParams
from stencilstream_tpu.models import fdtd as jf
from stencilstream_tpu.tdv import _batched_tdv

from test_fdtd import tiny_config

from stencilstream_tpu_torch import Params, create_update, interop
from stencilstream_tpu_torch.models import fdtd as pf
from stencilstream_tpu_torch.tdv import tdv_stream
from stencilstream_tpu_torch.utils import io

RESOLVERS = ("coef", "lut", "render")
FIELDS = ("ex", "ey", "hz", "hz_sum")
#: The port's backends on the CPU: the reference, and the plain versions of
#: the three kernels (the tile pass with partial passes, the line cache, the
#: resident grid), reached through the backends a user calls.
BACKENDS = {
    "reference": ("reference", {}),
    "tile_pass_plain": ("tiling", dict(iters_per_pass=3)),
    "line_cache_pass_plain": ("tiling", dict(iters_per_pass=3, window_mode="linecache", strip_rows=4)),
    "monotile_plain": ("monotile", {}),
}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fields(tf) -> dict:
    return {f.name: getattr(tf, f.name) for f in dataclasses.fields(tf)}


def _jax_amplitudes(jtf, offset: int, n: int) -> np.ndarray:
    """JAX's amplitudes for a call, evaluated as its precompute-on-host
    strategy evaluates them (one batched, compiled call)."""
    return np.asarray(_batched_tdv(jtf, jnp.arange(n) + int(offset)))


def _random_coefficients(rng, shape):
    """ca, da in [0.5, 1), cb, db in [0, 0.5): not 1 and not powers of two,
    so a fused and an unfused multiply-add round apart in many cells (with
    the tiny config's lossless ring, ca = da = 1 hides the difference)."""
    return {f: rng.uniform(0.5 if f in ("ca", "da") else 0.0, 1.0 if f in ("ca", "da") else 0.5,
                           shape).astype(np.float32) for f in ("ca", "cb", "da", "db")}


def _randomized(jtf, arrays, seed):
    """Random fields, and random coefficients: the coef cells', or the lut
    and render resolvers' tables."""
    rng = np.random.default_rng(seed)
    shape = arrays.ex.shape
    fields = {f: rng.standard_normal(shape).astype(np.float32) for f in FIELDS}
    if hasattr(arrays, "ca"):
        fields.update(_random_coefficients(rng, shape))
    if jtf.resolver_state is not None:
        table = _random_coefficients(rng, (16,))
        jtf = dataclasses.replace(jtf, resolver_state={
            **jtf.resolver_state, **{k: jnp.asarray(v) for k, v in table.items()}})
    return jtf, dataclasses.replace(arrays, **fields)


@dataclasses.dataclass
class _Case:
    """One run on both sides: JAX's kernel, grid and amplitudes, and JAX's
    output fields (reference backend, its precompute-on-host strategy)."""

    jtf: object
    arrays: object
    offset: int
    n: int
    amplitudes: np.ndarray
    want: object


_CASES = {}


def _case(resolver, offset=0, n=None, source_radius=0.0, seed=None) -> _Case:
    key = (resolver, offset, n, source_radius, seed)
    if key not in _CASES:
        p = jf.Parameters.from_json(tiny_config(source_radius=source_radius))
        jres = jf.RESOLVERS[resolver](p)
        jtf = jf.make_kernel(p, jres)
        arrays = jf.init_grid(p, jres).to_numpy()
        if seed is not None:
            jtf, arrays = _randomized(jtf, arrays, seed)
        n = p.n_timesteps() if n is None else n
        update = j_create_update(
            JParams(transition_function=jtf, halo_value=jres.halo_cell(), iteration_offset=offset,
                    n_iterations=n, tdv_strategy="precompute_on_host"),
            backend="reference",
        )
        want = update(JGrid.from_numpy(arrays)).to_numpy()
        _CASES[key] = _Case(jtf, arrays, offset, n, _jax_amplitudes(jtf, offset, n), want)
    return _CASES[key]


@dataclasses.dataclass
class _JaxAmplitudes(pf.FDTDKernel):
    """The port's kernel whose time-dependent value is JAX's amplitude:
    ``amplitudes[i - first]``, for a Python int or a tensor of indices."""

    amplitudes: object = None
    first: int = 0

    def get_time_dependent_value(self, i_iteration):
        i = torch.as_tensor(i_iteration, dtype=torch.long) - self.first
        return torch.from_numpy(self.amplitudes)[i]


def _port(case: _Case, resolver: str, backend: str, strategy: str):
    """The port's fields for ``case``, fed JAX's amplitudes: through the
    kernel's own TDV under a port strategy, or as an interop stream."""
    tf = interop.fdtd_kernel(resolver, _fields(case.jtf))
    if strategy == "interop stream":
        tdv = interop.StreamTDV(case.amplitudes, case.offset)
    else:
        tf = _JaxAmplitudes(**_fields(tf), amplitudes=case.amplitudes.copy(), first=case.offset)
        tdv = strategy
    name, kw = BACKENDS[backend]
    update = create_update(
        Params(tf, halo_value=pf.RESOLVERS[resolver].halo_cell(), iteration_offset=case.offset,
               n_iterations=case.n, tdv_strategy=tdv),
        backend=name, **kw,
    )
    return update(interop.fdtd_grid(resolver, case.arrays, device="cpu")).to_numpy()


def _assert_fields_equal(got, want):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


# -- parameters ---------------------------------------------------------------


@pytest.mark.parametrize("config", [
    tiny_config(),
    tiny_config(t_max=0.05, t_snap=0.02, source_radius=30e-9),
    pf.mono_benchmark(1024),
    pf.mono_benchmark(512),
    pf.MONO_BENCHMARK,
], ids=["tiny", "tiny-snap-disk", "mono-1024-cut", "mono-512-cut", "mono-1024"])
def test_parameters_derive_what_jax_derives(config):
    j, p = jf.Parameters.from_json(config), pf.Parameters.from_json(config)
    for name in ("dt", "n_timesteps", "n_snap_timesteps", "omega", "grid_range", "source_r",
                 "source_c", "t_0", "t_cutoff", "t_detect", "t_max"):
        assert getattr(p, name)() == getattr(j, name)(), name
    assert dataclasses.asdict(p) == dataclasses.asdict(j)


def _broken(edit):
    cfg = tiny_config()
    edit(cfg)
    return cfg


@pytest.mark.parametrize("config", [
    _broken(lambda c: c["time"].pop("t_max")),
    _broken(lambda c: c.update(tau="not a number")),
    _broken(lambda c: c["cavity_rings"][0].update(radius=-1.0)),
    _broken(lambda c: c.update(cavity_rings=c["cavity_rings"] * 16)),
    _broken(lambda c: c.pop("source")),
    _broken(lambda c: c.update(time=[])),
    _broken(lambda c: c.update(cavity_rings={})),
    _broken(lambda c: c["source"].update(x=True)),
], ids=["missing", "not-a-number", "negative-radius", "too-many-rings", "missing-object",
        "not-an-object", "not-an-array", "bool"])
def test_schema_errors_are_jax_errors(config):
    with pytest.raises(jf.params.ConfigError) as want:
        jf.Parameters.from_json(config)
    with pytest.raises(pf.params.ConfigError) as got:
        pf.Parameters.from_json(config)
    assert str(got.value) == str(want.value)


# -- materials ------------------------------------------------------------------


@pytest.mark.parametrize("resolver", RESOLVERS)
def test_resolver_cells_and_grid_match_jax(resolver):
    p = jf.Parameters.from_json(tiny_config())
    jres, pres = jf.RESOLVERS[resolver](p), pf.RESOLVERS[resolver](p)
    for ring in (0, 1):
        want, got = jres.cell_from_parameters(p, ring), pres.cell_from_parameters(p, ring)
        for f in dataclasses.fields(want):
            assert np.asarray(getattr(got, f.name)).dtype == np.asarray(getattr(want, f.name)).dtype
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    want, got = jf.init_grid(p, jres).to_numpy(), pf.init_grid(p, pres, device="cpu").to_numpy()
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name), getattr(want, f.name), err_msg=f.name)
        assert getattr(got, f.name).dtype == getattr(want, f.name).dtype


@pytest.mark.parametrize("resolver", RESOLVERS)
def test_resolver_coefficients_match_jax(resolver):
    """Each resolver's ``coefficients()`` on cells with every ring index
    (and two outside the table) and on distance scores around every ring's
    bound: exactly JAX's."""
    p = jf.Parameters.from_json(tiny_config(radius=40e-9))
    p.rings = p.rings * 3  # three rings, so the table has several entries
    jres, pres = jf.RESOLVERS[resolver](p), pf.RESOLVERS[resolver](p)
    rng = np.random.default_rng(3)
    shape = (6, 7)
    cell = jres.MaterialCell(**{
        f.name: (rng.integers(-2, 18, shape).astype(np.int32) if f.name == "index"
                 else rng.uniform(0, 1, shape).astype(np.float32))
        for f in dataclasses.fields(jres.MaterialCell)
    })
    scores = rng.uniform(-250, 150, shape).astype(np.float32)
    want = jres.coefficients(jres.kernel_state(), cell, jnp.asarray(scores))
    state = pres.kernel_state()
    port_cell = pres.MaterialCell(**{k: torch.from_numpy(v) for k, v in dataclasses.asdict(cell).items()})
    got = pres.coefficients(state, port_cell, torch.from_numpy(scores))
    for f in ("ca", "cb", "da", "db"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(want, f)), err_msg=f)
    if state is not None:
        for k, v in jres.kernel_state().items():
            np.testing.assert_array_equal(state[k], np.asarray(v), err_msg=k)


# -- the time-dependent value ----------------------------------------------------


def _full_run():
    """The tiny config over a full 15 tau run (64238 iterations)."""
    p = pf.Parameters.from_json(tiny_config(t_max=15.0))
    return p, p.n_timesteps()


def test_amplitude_within_two_ulps_of_float64():
    """The port's amplitude against float64 ``cos`` and ``exp`` of the same
    float32 arguments, over every iteration of a 15 tau run: within 2 ulps
    of the float64 value (float32 ulps at that value)."""
    p, n = _full_run()
    tf = pf.make_kernel(p, pf.CoefResolver(p))
    got = tf.get_time_dependent_value(torch.arange(n, dtype=torch.int32)).numpy()
    i = np.arange(n, dtype=np.int32)
    t = i.astype(np.float32) * np.float32(tf.dt)
    progress = (t - np.float32(tf.t_0)) / np.float32(tf.tau)
    x = t * np.float32(tf.omega)
    y = -progress * progress
    want = np.cos(x.astype(np.float64)) * np.exp(y.astype(np.float64))
    ulps = np.abs(got.astype(np.float64) - want) / np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    assert got.dtype == np.float32 and ulps.max() <= 2.0, ulps.max()
    assert np.abs(got).max() > 0.99  # the pulse's peak lies in the run


def test_amplitude_within_4e_5_of_jax():
    """Against JAX's amplitudes over the same run: XLA's float32 ``cos``
    errs by up to ~3e-5 at these arguments (w t up to ~1131 rad), so the
    two agree to 4e-5, not to the bit."""
    p, n = _full_run()
    tf = pf.make_kernel(p, pf.CoefResolver(p))
    got = tf.get_time_dependent_value(torch.arange(n, dtype=torch.int32)).numpy()
    want = _jax_amplitudes(jf.make_kernel(jf.Parameters.from_json(tiny_config(t_max=15.0)),
                                          jf.CoefResolver(p)), 0, n)
    assert np.abs(got - want).max() <= 4e-5


def test_amplitude_does_not_depend_on_the_batch():
    """A resumed call's stream equals the same iterations of a one-shot
    call's, element for element, under every strategy; a Python int gives
    the same value as the batch."""
    p, n = _full_run()
    tf = pf.make_kernel(p, pf.CoefResolver(p))
    whole = tf.get_time_dependent_value(torch.arange(n, dtype=torch.int32))
    for strategy in ("inline", "precompute_on_device", "precompute_on_host"):
        for offset, count in ((0, 5), (1, 17), (12837, 33), (n - 7, 7)):
            stream = tdv_stream(tf, offset, count, "cpu", strategy)
            assert torch.equal(stream, whole[offset:offset + count]), (strategy, offset)
    for i in (0, 12848, n - 1):
        assert torch.equal(tf.get_time_dependent_value(i), whole[i])


# -- fields, bit for bit -----------------------------------------------------------


@pytest.mark.parametrize("strategy", ["inline", "precompute_on_device", "precompute_on_host",
                                      "interop stream"])
@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("resolver", RESOLVERS)
def test_fields_equal_jax_with_its_amplitudes(resolver, backend, strategy):
    """The tiny config's whole run (86 iterations) from its initial grid:
    each resolver, on the reference and on each kernel's plain version,
    under each TDV strategy fed JAX's amplitudes: exactly JAX's fields."""
    case = _case(resolver)
    got = _port(case, resolver, backend, strategy)
    _assert_fields_equal(got, case.want)
    assert np.abs(got.hz).max() > 0  # the wave propagated


@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("resolver", RESOLVERS)
def test_disk_source_on_random_fields_equals_jax(resolver, backend):
    """Random fields and coefficients, an interpolated disk source of radius
    3 cells, six iterations from 12840, where the amplitude is near 1:
    exactly JAX's."""
    case = _case(resolver, offset=12840, n=6, source_radius=30e-9, seed=11)
    assert np.abs(case.amplitudes).max() > 0.9
    _assert_fields_equal(_port(case, resolver, backend, "inline"), case.want)


@pytest.mark.parametrize("edge", ["cutoff", "detect"])
@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("resolver", RESOLVERS)
def test_offsets_across_cutoff_and_detect_equal_jax(resolver, backend, edge):
    """Random fields and coefficients, seven iterations from three before
    the cutoff (the source switches off) or the detect iteration (hz_sum
    starts to accumulate): exactly JAX's."""
    p = jf.Parameters.from_json(tiny_config())
    jtf = jf.make_kernel(p, jf.CoefResolver(p))
    at = jtf.cutoff_iteration if edge == "cutoff" else jtf.detect_iteration
    case = _case(resolver, offset=at - 3, n=7, seed=12)
    _assert_fields_equal(_port(case, resolver, backend, "inline"), case.want)
    if edge == "detect":
        assert not np.array_equal(case.want.hz_sum, case.arrays.hz_sum)


# -- the port on its own -------------------------------------------------------------


def test_three_resolvers_agree_exactly():
    p = pf.Parameters.from_json(tiny_config())
    out = {name: pf.run(p, pf.RESOLVERS[name](p), snapshots=False, backend="reference",
                        device="cpu")[0].to_numpy() for name in RESOLVERS}
    for name in ("lut", "render"):
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(out[name], f), getattr(out["coef"], f), err_msg=(name, f))
    assert np.abs(out["coef"].hz).max() > 0


@pytest.mark.parametrize("backend", ["reference", "tiling", "monotile"])
def test_snapshot_resume_equals_one_shot(tmp_path, backend):
    """Pausing every n_snap iterations and resuming through
    iteration_offset gives the one-shot run's fields, and writes one hz
    frame a pause."""
    p = pf.Parameters.from_json(tiny_config(t_max=0.02, t_snap=0.008), out_dir=str(tmp_path))
    n_snap = p.n_snap_timesteps()
    total = -(-p.n_timesteps() // n_snap) * n_snap
    update, resolver = pf.build_simulation(p, n_iterations=total, backend=backend)
    one_shot = update(pf.init_grid(p, resolver, device="cpu")).to_numpy()
    with_snaps = pf.run(p, snapshots=True, backend=backend, device="cpu")[0].to_numpy()
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(with_snaps, f), getattr(one_shot, f), err_msg=f)
    frames = sorted(tmp_path.glob("hz.*.csv"))
    assert len(frames) == total // n_snap
    assert np.loadtxt(frames[0], delimiter=",").shape == (20, 20)


def test_hz_sum_accumulates_only_after_detect():
    cfg = tiny_config(t_max=0.02)
    grid, _ = pf.run(pf.Parameters.from_json(cfg), snapshots=False, device="cpu")
    np.testing.assert_array_equal(grid.to_numpy().hz_sum, 0.0)
    cfg["time"]["t_detect"] = 0.0
    grid, _ = pf.run(pf.Parameters.from_json(cfg), snapshots=False, device="cpu")
    assert grid.to_numpy().hz_sum.max() > 0


def test_csv_frame_writer_matches_jax(tmp_path):
    from stencilstream_tpu.utils.io import write_csv_frame as j_write_csv_frame

    values = np.random.default_rng(4).standard_normal((5, 7)).astype(np.float32)
    io.write_csv_frame(str(tmp_path / "port.csv"), values)
    j_write_csv_frame(str(tmp_path / "jax.csv"), values)
    assert (tmp_path / "port.csv").read_text() == (tmp_path / "jax.csv").read_text()


def test_cli_end_to_end(tmp_path):
    """``python -m stencilstream_tpu_torch.models.fdtd --device cpu`` on the
    20^2 tiny config: the JAX CLI's report lines and a 20x20 hz_sum frame
    equal to the library run's."""
    cfg = tiny_config(t_max=0.01)
    cfg["time"]["t_detect"] = 0.0
    (tmp_path / "exp.json").write_text(json.dumps(cfg))
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    proc = subprocess.run(
        [sys.executable, "-m", "stencilstream_tpu_torch.models.fdtd", "-c", str(tmp_path / "exp.json"),
         "-o", str(out_dir), "--material", "lut", "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "Walltime:" in proc.stdout and "grid w/h          = 20 cells" in proc.stdout
    (frame,) = out_dir.glob("hz_sum.*.csv")
    data = np.loadtxt(frame, delimiter=",")
    assert data.shape == (20, 20) and data.max() > 0
    p = pf.Parameters.from_json(cfg)
    want = pf.run(p, pf.LUTResolver(p), snapshots=False, device="cpu")[0].to_numpy().hz_sum
    np.testing.assert_allclose(data, want, rtol=1e-5, atol=0)
