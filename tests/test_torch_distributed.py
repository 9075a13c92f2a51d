"""The distributed backend of the PyTorch/CUDA port against the JAX package.

The port's mesh names the CPU device at every position (a single-process
mesh, as on one card); the JAX package's runs inside ``shard_map`` on the
eight virtual CPU devices of tests/conftest.py, on a mesh of the same
shape. Every case is held three ways: against the port's ``reference``
backend bit for bit (the kernel's plain version and the plain local
compute evaluate each cell as the reference does), against JAX's
``reference`` and against JAX's ``distributed`` backend (``local_compute=
"xla"``; one case ``"pallas"`` in interpret mode), with the tolerances the
apps' own parity tests state for whole runs: HotSpot, Conway and the probe
bit for bit; Jacobi5 at halo 0.5 bit for bit beyond n cells of the edge and
within 1e-6 there (XLA folds a constant halo tap, tests/test_torch_jacobi.py);
FDTD bit for bit against JAX's reference given JAX's amplitudes
(``interop.StreamTDV``). JAX's own FDTD is not bit for bit across its
backends: its ``distributed`` and ``tiling`` results differ from its
``reference`` by up to 1.9e-6 in ``hz_sum`` (about two ulps there; XLA
contracts the fused window's multiply-adds otherwise), so the port's FDTD is
held within 4e-6 of JAX's multi-device backends; nor is its Jacobi5, whose
``ring`` differs from its ``reference`` by an ulp (6e-8) inside the grid
too, so the port's Jacobi5 is held within 1e-6 of them everywhere.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencilstream_tpu.backends import create_update as j_create_update
from stencilstream_tpu.core import Grid as JGrid
from stencilstream_tpu.core import Params as JParams
from stencilstream_tpu.models import conway as jc
from stencilstream_tpu.models import fdtd as jf
from stencilstream_tpu.models import hotspot as jhs
from stencilstream_tpu.models import jacobi as jj
from stencilstream_tpu.parallel import make_mesh as j_make_mesh
from stencilstream_tpu.tdv import _batched_tdv

import probe as jprobe
from test_fdtd import tiny_config

from stencilstream_tpu_torch import Params, create_update, interop, probe
from stencilstream_tpu_torch.backends.auto import choose_backend
from stencilstream_tpu_torch.models import fdtd as pf
from stencilstream_tpu_torch.parallel import make_mesh

STRONG = dict(Rx_1=np.float32(0.1), Ry_1=np.float32(0.1), Rz_1=np.float32(0.05), Cap_1=np.float32(0.5))
JACOBI5 = [0.15, 0.2, 0.25, 0.1, 0.3]
MESHES = [(1, 1), (2, 1), (1, 2), (2, 2), (4, 1)]
APPS = ["hotspot", "jacobi5", "conway", "probe_radius2", "fdtd_coef"]
#: Iterations a pass: 2, so that n=5 ends on a partial pass; the probe's
#: radius-2, two-sub-step window at p=1 (its halo still 4 cells) keeps JAX's
#: unrolled shrinking window small enough to compile in a second.
PASS = {"hotspot": 2, "jacobi5": 2, "conway": 2, "probe_radius2": 1, "fdtd_coef": 2}


@dataclasses.dataclass
class Case:
    """One app's run on both sides: JAX's transition function, halo, grid
    and parameters; the port's; the comparison with JAX."""

    jtf: object
    jhalo: object
    jgrid: object
    tf: object
    halo: object
    grid: object
    offset: int
    n: int
    kind: str  # "exact" or "jacobi"
    jtdv: str = "inline"
    tdv: object = "inline"


def _leaves(x):
    if dataclasses.is_dataclass(x):
        return [np.asarray(getattr(x, f.name)) for f in dataclasses.fields(x)]
    return [np.asarray(x)]


def assert_matches(got, want, kind: str, n: int, what: str):
    """``got`` against ``want`` (numpy cells): exactly; for Jacobi exactly
    beyond ``n`` cells of the edge and within 1e-6 there; for ``"fdtd"``
    and ``"close"`` (JAX's FDTD and Jacobi5 on its multi-device backends)
    within 4e-6 and 1e-6 everywhere."""
    for j, (g, w) in enumerate(zip(_leaves(got), _leaves(want))):
        assert g.shape == w.shape, (what, j)
        if kind == "exact":
            np.testing.assert_array_equal(g, w, err_msg=f"{what} field {j}")
        elif kind in ("fdtd", "close"):
            atol = 4e-6 if kind == "fdtd" else 1e-6
            np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=f"{what} field {j}")
        else:
            np.testing.assert_array_equal(g[n:-n, n:-n], w[n:-n, n:-n], err_msg=f"{what} interior")
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=what)


def multi_device_kind(app: str, kind: str) -> str:
    """The comparison with JAX's ``distributed`` and ``ring`` backends."""
    return {"fdtd_coef": "fdtd", "jacobi5": "close"}.get(app, kind)


def make_case(app: str, shape=(21, 26), offset=2, n=5, seed=0) -> Case:
    """The same numpy inputs for both packages."""
    rng = np.random.default_rng(seed)
    if app == "hotspot":
        cell = jhs.HotspotCell(temp=rng.uniform(70, 90, shape).astype(np.float32),
                               power=rng.uniform(0, 1e-3, shape).astype(np.float32))
        jk = jhs.HotspotKernel(**STRONG)
        return Case(jk, None, JGrid.from_numpy(cell), interop.hotspot_kernel(dataclasses.asdict(jk)), None,
                    interop.hotspot_grid(cell, device="cpu"), offset, n, "exact")
    if app == "jacobi5":
        x = rng.random(shape, np.float32)
        jk = jj.make_kernel("jacobi5_general", JACOBI5)
        return Case(jk, jnp.float32(0.5), JGrid.from_numpy(x), interop.jacobi_kernel("jacobi5_general", jk), 0.5,
                    interop.grid_from_numpy(None, x, device="cpu"), offset, n, "jacobi")
    if app == "conway":
        soup = rng.random(shape) < 0.4
        return Case(jc.ConwayKernel(), None, JGrid.from_numpy(soup), interop_conway(), None,
                    interop.conway_grid(soup, device="cpu"), offset, n, "exact")
    if app == "probe_radius2":
        return Case(jprobe.ProbeTransFunc(radius_=2), jprobe.probe_halo_cell(),
                    jprobe.make_probe_grid(*shape, offset), probe.ProbeTransFunc(radius_=2),
                    probe.probe_halo_cell(), probe.make_probe_grid(*shape, offset, device="cpu"), offset, n, "exact")
    assert app == "fdtd_coef"
    p = jf.Parameters.from_json(tiny_config())
    jres = jf.RESOLVERS["coef"](p)
    jtf = jf.make_kernel(p, jres)
    arrays = jf.init_grid(p, jres).to_numpy()
    fields = {f: rng.standard_normal(arrays.ex.shape).astype(np.float32) for f in ("ex", "ey", "hz", "hz_sum")}
    fields.update({f: rng.uniform(0.5 if f in ("ca", "da") else 0.0, 1.0 if f in ("ca", "da") else 0.5,
                                  arrays.ex.shape).astype(np.float32) for f in ("ca", "cb", "da", "db")})
    arrays = dataclasses.replace(arrays, **fields)
    offset = int(jtf.detect_iteration) - 2  # detection starts inside the run
    amplitudes = np.asarray(_batched_tdv(jtf, jnp.arange(n) + offset))
    return Case(jtf, jres.halo_cell(), JGrid.from_numpy(arrays),
                interop.fdtd_kernel("coef", {f.name: getattr(jtf, f.name) for f in dataclasses.fields(jtf)}),
                pf.RESOLVERS["coef"].halo_cell(), interop.fdtd_grid("coef", arrays, device="cpu"), offset, n,
                "exact", jtdv="precompute_on_host", tdv=interop.StreamTDV(amplitudes, offset))


def interop_conway():
    from stencilstream_tpu_torch.models import conway

    return conway.ConwayKernel()


def jax_run(case: Case, backend: str, **kw):
    params = JParams(transition_function=case.jtf, halo_value=case.jhalo, iteration_offset=case.offset,
                     n_iterations=case.n, tdv_strategy=case.jtdv)
    update = j_create_update(params, backend=backend, **kw)
    update.fallback_to_reference = False
    return update(case.jgrid).to_numpy()


def port_run(case: Case, backend: str, **kw):
    params = Params(case.tf, halo_value=case.halo, iteration_offset=case.offset, n_iterations=case.n,
                    tdv_strategy=case.tdv)
    update = create_update(params, backend=backend, **kw)
    return update(case.grid), update


_JAX = {}


def jax_cached(app: str, backend: str, key=(), **kw):
    """JAX's result for an app's default case, computed once per module."""
    k = (app, backend, key)
    if k not in _JAX:
        _JAX[k] = jax_run(make_case(app), backend, **kw)
    return _JAX[k]


def cpu_mesh(shape):
    return make_mesh(shape=shape, devices=["cpu"] * int(np.prod(shape)))


@pytest.mark.parametrize("local_compute", ["kernel", "plain"])
@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("app", APPS)
def test_distributed_matches_reference_and_jax(app, mesh_shape, local_compute):
    """21x26 (not a multiple of any mesh), n=5 from iteration 2 (FDTD from
    two before detection) at p=2, so the last pass is partial; the probe
    at r=2, k=2, p=1 has a halo of 4 cells."""
    case = make_case(app)
    ipp = PASS[app]
    out, update = port_run(case, "distributed", mesh=cpu_mesh(mesh_shape), iters_per_pass=ipp,
                           local_compute=local_compute)
    assert update.resolved_config["mesh"] == mesh_shape
    got = out.to_numpy()
    want, _ = port_run(case, "reference")
    assert_matches(got, want.to_numpy(), "exact", case.n, "port reference")
    assert_matches(got, jax_cached(app, "reference"), case.kind, case.n, "JAX reference")
    jdist = jax_cached(app, "distributed", mesh_shape, mesh=j_make_mesh(shape=mesh_shape), iters_per_pass=ipp,
                       local_compute="xla")
    assert_matches(got, jdist, multi_device_kind(app, case.kind), case.n, "JAX distributed")
    if app.startswith("probe"):
        probe.check_probe_grid(out, case.offset + case.n)


def test_distributed_matches_jax_pallas_in_interpret_mode():
    """HotSpot on a (2, 2) mesh: JAX's Pallas local compute (interpret
    mode, its extended strip pass behind a lane-aligned column halo)."""
    case = make_case("hotspot")
    mesh = j_make_mesh(shape=(2, 2))
    want = jax_run(case, "distributed", mesh=mesh, iters_per_pass=2, local_compute="pallas")
    out, _ = port_run(case, "distributed", mesh=cpu_mesh((2, 2)), iters_per_pass=2)
    assert_matches(out.to_numpy(), want, "exact", case.n, "JAX distributed pallas")


@pytest.mark.parametrize("local_compute", ["kernel", "plain"])
@pytest.mark.parametrize("iters_per_pass", [1, 3, 8])
def test_shards_smaller_than_the_halo_are_padded(iters_per_pass, local_compute):
    """A 7x9 grid on a (4, 2) mesh: at p=3 (halo 3) and p=8 (halo 8, more
    than the grid) every shard is padded to the halo; n=8 from 1."""
    case = make_case("hotspot", shape=(7, 9), offset=1, n=8, seed=5)
    out, update = port_run(case, "distributed", mesh=cpu_mesh((4, 2)), iters_per_pass=iters_per_pass,
                           local_compute=local_compute)
    hp = min(iters_per_pass, 8)
    assert update.resolved_config["shard"] == (max(2, hp), max(5, hp))
    want, _ = port_run(case, "reference")
    assert_matches(out.to_numpy(), want.to_numpy(), "exact", case.n, "port reference")
    assert_matches(out.to_numpy(), jax_run(case, "reference"), "exact", case.n, "JAX reference")


def test_distributed_on_a_mesh_that_repeats_a_device_twice():
    """A mesh of two CPU positions beside a mesh of one: the same cells."""
    case = make_case("jacobi5", shape=(30, 17), offset=0, n=9, seed=3)
    a, _ = port_run(case, "distributed", mesh=cpu_mesh((2, 1)), iters_per_pass=4)
    b, _ = port_run(case, "distributed", mesh=cpu_mesh((1, 1)), iters_per_pass=4)
    assert_matches(a.to_numpy(), b.to_numpy(), "exact", case.n, "(2, 1) against (1, 1)")


def test_zero_iterations_return_the_grid():
    case = make_case("hotspot", n=0)
    out, _ = port_run(case, "distributed", mesh=cpu_mesh((2, 2)))
    assert_matches(out.to_numpy(), case.grid.to_numpy(), "exact", 0, "n=0")


def test_distributed_needs_a_mesh_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_update(Params(interop_conway(), n_iterations=1), backend="distributed")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_update(Params(interop_conway(), n_iterations=1), backend="ring")
    with pytest.raises(ValueError, match="local_compute"):
        create_update(Params(interop_conway(), n_iterations=1), backend="distributed", mesh=cpu_mesh((1, 1)),
                      local_compute="xla")


#: Grids that both packages' capacity laws route alike on one device:
#: monotile (fits both), tiling (fits neither).
ROUTES = [
    ("hotspot", (64, 64)),
    ("hotspot", (600, 40)),
    ("hotspot", (2048, 2048)),
    ("hotspot", (4096, 512)),
    ("jacobi5", (100, 100)),
    ("jacobi5", (3000, 3000)),
    ("conway", (40, 30)),
]


@pytest.mark.parametrize("n_devices", [1, 2, 8])
@pytest.mark.parametrize("app,shape", ROUTES, ids=[f"{a}-{s[0]}x{s[1]}" for a, s in ROUTES])
def test_choose_backend_takes_distributed_where_jax_does(app, shape, n_devices):
    from stencilstream_tpu.backends.auto import choose_backend as j_choose

    if app == "hotspot":
        jgrid = JGrid.from_numpy(jhs.HotspotCell(temp=np.zeros(shape, np.float32), power=np.zeros(shape, np.float32)))
        grid, tf = interop.hotspot_grid(jgrid.to_numpy(), device="cpu"), interop.hotspot_kernel(
            dataclasses.asdict(jhs.HotspotKernel()))
    elif app == "jacobi5":
        jgrid = JGrid.from_numpy(np.zeros(shape, np.float32))
        grid = interop.grid_from_numpy(None, np.zeros(shape, np.float32), device="cpu")
        tf = interop.jacobi_kernel("jacobi5_general", jj.make_kernel("jacobi5_general", JACOBI5))
    else:
        jgrid = JGrid.from_numpy(np.zeros(shape, bool))
        grid, tf = interop.conway_grid(np.zeros(shape, bool), device="cpu"), interop_conway()
    want = j_choose(jgrid, n_devices=n_devices)
    assert choose_backend(grid, tf, n_devices=n_devices) == want
    if n_devices == 1:
        assert choose_backend(grid, tf) == want  # a CPU grid sees one device
