"""The CUDA kernels' wrappers in the PyTorch/CUDA port.

This file imports no JAX, so its card tests run where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

(``--noconftest`` skips tests/conftest.py, which sets up JAX). Tests marked
``gpu`` need a CUDA card and skip without one; the others check, on the CPU,
that a wrapper given CPU tensors runs its plain version and launches nothing.

Tolerance on the card: atol 1e-4 at HotSpot's temperatures in [70, 90] and
1e-5 at Jacobi's values in [0, 5]. A kernel and its plain version evaluate
the same float32 operations in the same order, with the same fused
multiply-adds, so they agree to a few ulps (7.6e-6 at 80, 4.8e-7 at 5);
with the strong coefficients one iteration moves temperatures by ~1e-1.
Conway's and the probe's integer cells must agree exactly, and so must
FDTD's fields: the kernel and its plain version read one TDV stream, and
FDTD's update has no operation whose rounding could differ (each fused
multiply-add is explicit in both). So must every cell on narrow storage
(bfloat16, float8 e4m3): both round each float32 result to the storage type
to nearest even, float8 overflow to NaN, and a NaN on both sides counts as
equal.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

from stencilstream_tpu_torch import Grid, Params, create_update, probe
from stencilstream_tpu_torch.backends import cuda_lib
from stencilstream_tpu_torch.backends import line_cache as lc
from stencilstream_tpu_torch.backends import monotile as mt
from stencilstream_tpu_torch.backends import tile_pass as tp
from stencilstream_tpu_torch.backends.storage_cast import CastStorageKernel, cast_storage
from stencilstream_tpu_torch.core.cell import cell_leaves
from stencilstream_tpu_torch.experiments import linecache as mlc
from stencilstream_tpu_torch.experiments import strip
from stencilstream_tpu_torch.models import convection, conway, fdtd, jacobi
from stencilstream_tpu_torch.models import hotspot as hs
from stencilstream_tpu_torch.tdv import tdv_stream
from stencilstream_tpu_torch.tile_sweep import convection_case
from stencilstream_tpu_torch.trace_cells import convection_experiment

STRONG = dict(Rx_1=np.float32(0.1), Ry_1=np.float32(0.1), Rz_1=np.float32(0.05), Cap_1=np.float32(0.5))
ATOL = 1e-4


def _cell(shape, seed, device, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return hs.HotspotCell(
        temp=torch.tensor(rng.uniform(70, 90, shape), dtype=dtype, device=device),
        power=torch.tensor(rng.uniform(0, 1e-3, shape), dtype=dtype, device=device),
    )


#: Distinct coefficients per Jacobi variant, so a wrong tap shows.
JACOBI_COEFS = {
    "jacobi1_general": [0.9],
    "jacobi4_general": [0.1, 0.2, 0.3, 0.4],
    "jacobi5_general": [0.15, 0.2, 0.25, 0.1, 0.3],
    "jacobi9_general": [0.05, 0.1, 0.15, 0.2, 0.02, 0.13, 0.07, 0.11, 0.17],
}
#: Every device functor: HotSpot, the eight Jacobi variants, Conway, the probe.
OPS = ["hotspot", *sorted(jacobi.VARIANTS), "conway", "probe"]
#: The functors whose transition functions have a time-dependent value: the
#: probe's at radius 1 and 2, FDTD's for each material resolver.
TDV_OPS = ["probe_tdv", "probe_radius2", "fdtd_coef", "fdtd_lut", "fdtd_render"]
#: The narrow instantiations (csrc/ops/all.cuh: SS_FOR_EACH_NARROW_OP), by
#: their entry points' names: bfloat16 and float8 e4m3 cells, float32 math.
NARROW_OPS = ["hotspot__bf16", "jacobi5_general__bf16", "fdtd_coef__bf16", "jacobi5_general__e4m3"]
ALL_OPS = OPS + TDV_OPS + NARROW_OPS
#: The probes, whose cells must all stay Normal.
PROBES = ("probe", "probe_tdv", "probe_radius2")
#: The convection functors: pseudo-transient (full and lean, straight and
#: folded) and thermal, in float32 and float64.
CONVECTION_OPS = [f"convection_{kind}_{width}" for kind in ("pt", "pt_lean", "thermal", "folded_pt", "folded_pt_lean")
                  for width in ("f32", "f64")]


def _case(op, shape, seed, device, iteration=0):
    """(cell, transition function, halo cell, tolerance) for a functor; the
    halo is non-zero (HotSpot 5.0 and 0.25, Jacobi 5.0), the probe's cells
    sit at ``iteration``. A narrow instantiation, ``<functor>__<storage>``,
    gets the functor's case with its float32 fields cast to the storage type
    and its transition function wrapped, exactly."""
    functor, _, suffix = op.partition("__")
    if suffix:
        storage = _storage(suffix)
        cell, tf, halo, _ = _case(functor, shape, seed, device, iteration)
        return cast_storage(cell, storage), CastStorageKernel(tf, storage), halo, 0
    rng = np.random.default_rng(seed)
    if op == "hotspot":
        return _cell(shape, seed, device), hs.HotspotKernel(**STRONG), hs.HotspotCell(temp=5.0, power=0.25), ATOL
    if op in jacobi.VARIANTS:
        x = torch.tensor(rng.random(shape, np.float32), device=device)
        return x, jacobi.make_kernel(op, JACOBI_COEFS.get(op, [])), 5.0, 1e-5
    if op == "conway":
        return torch.tensor(rng.random(shape) < 0.4, device=device), conway.ConwayKernel(), False, 0
    if op.startswith("fdtd_"):
        return _fdtd_case(op[len("fdtd_"):], shape, rng, device, iteration)
    if op.startswith("convection_"):
        return (*convection_case(op, shape, rng, device), 0)
    grid = probe.make_probe_grid(*shape, iteration, device=device)
    if op in ("probe_tdv", "probe_radius2"):
        return grid.arrays, probe.ProbeTransFunc(radius_=1 if op == "probe_tdv" else 2), probe.probe_halo_cell(), 0
    return grid.arrays, probe.ProbeKernel(), probe.probe_halo_cell(), 0


def _storage(suffix):
    """The storage dtype an entry point's suffix names."""
    (dtype,) = [d for d, s in cuda_lib.STORAGE_SUFFIX.items() if s == suffix]
    return dtype


def _fdtd_case(resolver, shape, rng, device, iteration):
    """FDTD with random fields and random coefficients (the coef cells', the
    lut indices, some outside the table, and the lut and render tables), a
    disk source of radius 3 cells at the grid's centre that switches off two
    iterations after ``iteration``, detection from the one after it, and a
    non-zero halo (the lut index's halo 3, as float32 bits a denormal)."""
    h, w = shape
    p = _fdtd_parameters(20)
    res = fdtd.RESOLVERS[resolver](p)
    tf = fdtd.make_kernel(p, res)
    sr, sc = h // 2, w // 2
    state = tf.resolver_state
    if state is not None:
        state = {**state, **{f: rng.uniform(0, 1, 16).astype(np.float32) for f in ("ca", "cb", "da", "db")}}
        if "bounds" in state:
            state["bounds"] = np.sort(rng.uniform(-h * h / 2, 0, 16)).astype(np.float32)
    tf = dataclasses.replace(
        tf, source_r=np.float32(sr), source_c=np.float32(sc), source_radius_squared=9.0,
        source_distance_bound=np.float32(9 - sr * sr - sc * sc), double_center_rc=np.float32(h),
        cutoff_iteration=iteration + 2, detect_iteration=iteration + 1, resolver_state=state,
    )
    fields = {f.name: torch.tensor(rng.uniform(-1, 1, shape).astype(np.float32), device=device)
              for f in dataclasses.fields(res.MaterialCell)}
    halo = dict(ex=0.25, ey=-0.5, hz=0.75, hz_sum=1.0)
    if resolver == "lut":
        fields["index"] = torch.tensor(rng.integers(-1, 17, shape).astype(np.int32), device=device)
        halo["index"] = 3
    if resolver == "coef":
        halo.update(ca=0.5, cb=0.125, da=0.5, db=0.125)
    return res.MaterialCell(**fields), tf, res.MaterialCell(**halo), 0


def _fdtd_parameters(side):
    """The mono-benchmark's FDTD experiment, time axis cut, on a side^2 grid."""
    return fdtd.Parameters.from_json(fdtd.mono_benchmark(side))


def _max_err(a, b):
    return max(float((x.double() - y.double()).abs().max()) for x, y in zip(cell_leaves(a), cell_leaves(b)))


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
    a = tp.tile_pass(cell, kernel, halo, i_start=0, offset=0, n_iterations=3, iters_per_pass=3, tile=(8, 32))
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
    assert set(cuda_lib.SOURCES) == {p.name for p in cuda_lib.CSRC.glob("*.cu")}
    assert set(cuda_lib.SOURCES) == {"tile_pass.cu", "monotile.cu", "line_cache.cu", "micro_strip.cu",
                                     "micro_linecache.cu"}


def test_every_functor_is_instantiated_in_every_kernel():
    """ops/all.cuh lists each functor the Python side names, once, and every
    kernel source expands its entry macro over that list."""
    listed = re.findall(r"X\((\w+), ss::(\w+)\)", (cuda_lib.CSRC / "ops" / "all.cuh").read_text())
    names = [name for name, _ in listed]
    assert sorted(names) == sorted(OPS + TDV_OPS + CONVECTION_OPS) and len(set(names)) == len(names)
    assert len({op for _, op in listed}) == len(listed)
    for tf in (hs.HotspotKernel(), conway.ConwayKernel(), probe.ProbeKernel(),
               *(jacobi.make_kernel(v, JACOBI_COEFS.get(v, [])) for v in jacobi.VARIANTS),
               *(probe.ProbeTransFunc(radius_=r) for r in (1, 2)),
               *(fdtd.make_kernel(_fdtd_parameters(20), cls(_fdtd_parameters(20))) for cls in fdtd.RESOLVERS.values()),
               *(_case(op, (2, 2), 0, "cpu")[1] for op in CONVECTION_OPS)):
        assert tf.cuda_op in names
    for src in cuda_lib.STENCIL_SOURCES:
        assert re.search(r"^SS_FOR_EACH_OP\(SS_\w+_ENTRY\)$", (cuda_lib.CSRC / src).read_text(), re.M), src


@pytest.mark.parametrize("vector", [True, False])
def test_tile_pass_counts_vector_map_launches_by_the_functors_info(monkeypatch, vector):
    """Each launch counts in ``launches``, and in ``vector_launches`` when the
    functor's compiled info says it takes the vector map."""
    monkeypatch.setattr(tp, "op_info", lambda op: {"vector_map": vector and op == "hotspot", "writes": None,
                                                   "reach": None})
    monkeypatch.setattr(tp, "launches", 5)
    monkeypatch.setattr(tp, "vector_launches", 2)
    assert tp.count_launch("hotspot") == ("vec4" if vector else "scalar")
    assert tp.count_launch("conway") == "scalar"
    assert (tp.launches, tp.vector_launches) == (7, 3 if vector else 2)


def test_tile_pass_counts_in_place_launches_by_the_functors_info(monkeypatch):
    """A launch whose functor updates in place counts in ``inplace_launches``
    and names the map ``inplace``; the others do not count there."""
    monkeypatch.setattr(tp, "op_info", lambda op: {"vector_map": op == "hotspot",
                                                   "writes": (3, 12) if op == "fdtd_coef" else None,
                                                   "reach": None})
    monkeypatch.setattr(tp, "launches", 0)
    monkeypatch.setattr(tp, "vector_launches", 0)
    monkeypatch.setattr(tp, "inplace_launches", 0)
    assert [tp.count_launch(op) for op in ("fdtd_coef", "hotspot", "conway", "fdtd_coef")] == [
        "inplace", "vec4", "scalar", "inplace"]
    assert (tp.launches, tp.vector_launches, tp.inplace_launches) == (4, 1, 2)


def test_tile_pass_counts_reach_launches_by_the_functors_info(monkeypatch):
    """A launch whose functor declares its sub-steps' reach counts in
    ``reach_launches`` beside its map's counter; one that declares writes
    but no reach, or neither, does not."""
    info = {"fdtd_coef": {"vector_map": False, "writes": (3, 12), "reach": ((1, 0), (0, 1))},
            "fdtd_coef__bf16": {"vector_map": False, "writes": None, "reach": None},
            "writes_only": {"vector_map": False, "writes": (3, 12), "reach": None},
            "hotspot": {"vector_map": True, "writes": None, "reach": None}}
    monkeypatch.setattr(tp, "op_info", info.__getitem__)
    for counter in ("launches", "vector_launches", "inplace_launches", "reach_launches"):
        monkeypatch.setattr(tp, counter, 0)
    assert [tp.count_launch(op) for op in ("fdtd_coef", "hotspot", "writes_only", "fdtd_coef__bf16", "fdtd_coef")] == [
        "inplace", "vec4", "inplace", "scalar", "inplace"]
    assert (tp.launches, tp.vector_launches, tp.inplace_launches, tp.reach_launches) == (5, 1, 3, 2)


@pytest.mark.parametrize("resolver", ["coef", "lut", "render"])
def test_fdtd_declares_its_one_sided_reach(resolver):
    """FDTD's sub-steps read one-sided: the pass's halo is p, not r*p*k = 2p;
    narrow storage's functor declares no reach and keeps 2p."""
    cell, tf, _, _ = _case(f"fdtd_{resolver}", (2, 2), 0, "cpu")
    assert cuda_lib.tile_reach(tf) == ((1, 0), (0, 1))
    assert [tp.pass_halo(1, p, 2, cuda_lib.tile_reach(tf)) for p in (1, 4, 8)] == [1, 4, 8]
    _, narrow, _, _ = _case("fdtd_coef__bf16", (2, 2), 0, "cpu")
    assert cuda_lib.tile_reach(narrow) is None and tp.pass_halo(1, 4, 2, cuda_lib.tile_reach(narrow)) == 8


def test_fdtds_reach_twin_is_its_functors_declaration():
    """The reach the CPU side sizes the halo from (``cuda_reach``) is the one
    ``FdtdT`` declares to the kernel (``csrc/ops/fdtd.cuh``: ``kReach``)."""
    source = (cuda_lib.CSRC / "ops" / "fdtd.cuh").read_text()
    declared = re.search(r"Reach kReach\[kSubiterations\] = \{(.*)\};", source)
    pairs = tuple(tuple(int(v) for v in pair) for pair in re.findall(r"\{(\d+), (\d+)\}", declared.group(1)))
    for op in ("fdtd_coef", "fdtd_lut", "fdtd_render"):
        assert cuda_lib.tile_reach(_case(op, (2, 2), 0, "cpu")[1]) == pairs == ((1, 0), (0, 1))


@pytest.mark.parametrize("op", ALL_OPS)
def test_cpu_tile_pass_runs_the_kernels_geometry(op):
    """On the CPU the tile pass computes each 8x32 tile from its own window,
    each sub-step narrowed as the kernel narrows it (by the functor's reach,
    or r a side), edge tiles and a partial pass included; its cells are the
    whole-block plain pass's exactly, and nothing launches."""
    cell, tf, halo, _ = _case(op, (37, 70), 1, "cpu", iteration=2)
    kw = dict(i_start=2, offset=1, n_iterations=3, iters_per_pass=3)
    before = tp.launches
    got = tp.tile_pass(cell, tf, halo, tile=(8, 32), **kw)
    assert tp.launches == before
    assert _max_err(got, tp.tile_pass_plain(cell, tf, halo, **kw)) == 0


@pytest.mark.parametrize("op", ["hotspot", "probe_radius2", "fdtd_coef"])
def test_cpu_tile_pass_with_a_halo_one_short_is_not_the_plain_pass(monkeypatch, op):
    """With the halo of a full pass one short, each sub-step still narrows
    the window as far, so the tiles' edge cells keep values from before the
    pass's last sub-steps and the cells differ from the whole-block plain
    pass."""
    cell, tf, halo, _ = _case(op, (37, 70), 1, "cpu", iteration=2)
    kw = dict(i_start=2, offset=1, n_iterations=4, iters_per_pass=3)
    want = tp.tile_pass_plain(cell, tf, halo, **kw)
    real = tp.pass_halo
    monkeypatch.setattr(tp, "pass_halo", lambda *a: real(*a) - 1)
    assert _max_err(tp.tile_pass(cell, tf, halo, tile=(8, 32), **kw), want) > 0


def test_bool_fields_reach_the_kernels_as_uint8_views():
    cells = torch.tensor([[True, False], [False, True]])
    view = cuda_lib.kernel_view(cells)
    assert view.dtype == torch.uint8 and view.data_ptr() == cells.data_ptr()
    assert view.tolist() == [[1, 0], [0, 1]]
    x = torch.zeros(2, 2)
    assert cuda_lib.kernel_view(x) is x
    assert cuda_lib._DTYPES[(1, 0)] == torch.uint8


@pytest.mark.parametrize("op", ALL_OPS)
def test_cpu_line_cache_pass_is_one_tile_pass(op):
    """On the CPU the line-cache wrapper runs its plain version, which is one
    tile pass's, and launches nothing."""
    cell, tf, halo, _ = _case(op, (11, 14), 1, "cpu", iteration=2)
    kw = dict(i_start=2, offset=1, n_iterations=3, iters_per_pass=3)
    before = lc.launches
    got = lc.line_cache_pass(cell, tf, halo, strip_rows=8, panel_cols=32, segment_rows=8, **kw)
    assert lc.launches == before
    assert _max_err(got, tp.tile_pass_plain(cell, tf, halo, **kw)) == 0


def test_int32_invariant_fields_reach_float_functors_as_bit_views():
    index = torch.tensor([[0, 3], [15, -1]], dtype=torch.int32)
    view = cuda_lib.kernel_view(index, torch.float32)
    assert view.dtype == torch.float32 and view.data_ptr() == index.data_ptr()
    assert view.view(torch.int32).tolist() == index.tolist()
    assert cuda_lib.kernel_view(index) is index and cuda_lib.kernel_view(index, torch.int32) is index
    assert cuda_lib._halo_bits(3, index, view) == float(np.array(3, np.int32).view(np.float32))
    assert cuda_lib._halo_bits(0, index, view) == 0.0
    assert cuda_lib._halo_bits(0.5, torch.zeros(1), torch.zeros(1)) == 0.5


def test_tdv_pointer_takes_only_a_stream_of_the_functors_type():
    """A functor without a time-dependent value gets NULL; one with a value
    gets the stream's pointer, which must be one contiguous tensor of at
    least n values of its type on the grid's device (the call's binding,
    :meth:`cuda_lib.Binding.stream_tdv`: one of a CPU cell, given the
    functor's name that a CUDA cell's binding finds)."""

    def tdv_pointer(tf, stream, n):
        call = cuda_lib.Binding(torch.zeros(2, 2), tf, 0.0, 0, n)
        call.op = cuda_lib.require_device_op(tf)
        call.stream_tdv(stream)
        return call.tdv_pointer

    assert tdv_pointer(hs.HotspotKernel(), None, 5) is None
    tf = probe.ProbeTransFunc()
    stream = torch.arange(5, dtype=torch.int32)
    assert tdv_pointer(tf, stream, 5) == stream.data_ptr()
    assert tdv_pointer(tf, None, 0) is None  # no step reads a call of 0
    for bad in (None, stream.float(), stream[:4], torch.arange(10, dtype=torch.int32)[::2],
                stream.view(1, 5), (stream,)):
        with pytest.raises(ValueError, match="cannot be streamed"):
            tdv_pointer(tf, bad, 5)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
@pytest.mark.parametrize("mode, kernel", [("clamped", tp), ("linecache", lc)])
def test_a_tiling_call_binds_once(monkeypatch, device, mode, kernel):
    """n = 2p + 1: three passes from one binding, each a launch of the
    mode's kernel on the card (the plain version on the CPU), and the
    reference's result."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    binds = []
    init = cuda_lib.Binding.__init__

    def counting_init(self, *args, **kwargs):
        binds.append(args)
        init(self, *args, **kwargs)

    monkeypatch.setattr(cuda_lib.Binding, "__init__", counting_init)
    grid = Grid(_cell((32, 64), 0, device))
    params = Params(hs.HotspotKernel(**STRONG), n_iterations=5)
    before = kernel.launches
    got = create_update(params, backend="tiling", iters_per_pass=2, window_mode=mode)(grid)
    assert len(binds) == 1
    assert kernel.launches - before == (3 if device == "cuda" else 0)
    want = create_update(params, backend="reference")(grid)
    assert _max_err(got.arrays, want.arrays) <= ATOL


def test_transition_functions_name_a_tdv_type_for_their_functor():
    """A time-dependent value needs a functor that takes one: the probes
    and FDTD name their stream's type, HotSpot with a TDV is refused."""
    assert cuda_lib.require_device_op(probe.ProbeTransFunc(radius_=2), 3) == "probe_radius2"
    assert probe.ProbeTransFunc(radius_=3).cuda_op is None
    with pytest.raises(NotImplementedError, match="ProbeTransFunc"):
        cuda_lib.require_device_op(probe.ProbeTransFunc(radius_=3))

    class WithTDV(hs.HotspotKernel):
        def get_time_dependent_value(self, i):
            return 1.0

    with pytest.raises(NotImplementedError, match="time-dependent value"):
        cuda_lib.require_device_op(WithTDV())


@pytest.mark.parametrize("resolver,n_params", [("coef", 8), ("lut", 8 + 64), ("render", 8 + 80)])
def test_fdtd_kernel_names_its_resolvers_functor(resolver, n_params):
    """``fdtd_<resolver>`` with the common parameters, then the table (and
    the render bounds), as csrc/ops/fdtd.cuh reads them."""
    p = _fdtd_parameters(1024)
    tf = fdtd.make_kernel(p, fdtd.RESOLVERS[resolver](p))
    params = tf.cuda_params()
    assert tf.cuda_op == f"fdtd_{resolver}" and len(params) == n_params
    assert params[:2] == (tf.cutoff_iteration, tf.detect_iteration) and params[5] == 0.0
    assert tf.cuda_tdv == torch.float32 and tf.cuda_variant == ("ex", "ey", "hz", "hz_sum")


@pytest.mark.parametrize("side,expect", [(1024, "tiling"), (512, "monotile")])
def test_auto_sends_fdtd_1024_to_tiling_and_512_to_monotile(side, expect):
    """The coef cell takes 48 B of shared memory (16 B variant twice, 16 B
    invariant): 1024^2 does not fit the resident grid on an H100, 512^2
    does."""
    from stencilstream_tpu_torch.backends.auto import choose_backend

    p = _fdtd_parameters(side)
    res = fdtd.CoefResolver(p)
    grid = fdtd.init_grid(p, res, device="cpu")
    tf = fdtd.make_kernel(p, res)
    assert cuda_lib.cell_smem_bytes(grid.arrays, tf) == 48
    assert choose_backend(grid, tf) == expect


#: The tile pass's geometry at tile_sweep.py's sizes (200 iterations a call)
#: for every functor that does not update in place, as it was before the
#: in-place law: (op, shape) -> (tile_h, tile_w, p).
PING_PONG_GEOMETRY = {
    **{(op, (8192, 8192)): (96, 112, 8) for op in sorted(jacobi.VARIANTS)},
    ("hotspot", (8192, 8192)): (56, 112, 8), ("conway", (8192, 8192)): (64, 240, 8),
    ("probe", (8192, 8192)): (32, 128, 2), ("probe_tdv", (8192, 8192)): (32, 128, 2),
    ("probe_radius2", (8192, 8192)): (32, 128, 1),
    ("hotspot__bf16", (8192, 8192)): (32, 240, 8), ("jacobi5_general__bf16", (8192, 8192)): (64, 240, 8),
    ("jacobi5_general__e4m3", (8192, 8192)): (64, 240, 8),
    ("fdtd_coef__bf16", (1024, 1024)): (28, 32, 4), ("fdtd_coef__bf16", (2048, 2048)): (28, 32, 4),
    ("convection_thermal_f32", (3072, 1024)): (16, 128, 4), ("convection_thermal_f64", (3072, 1024)): (24, 64, 1),
    ("convection_folded_pt_f32", (3072, 1024)): (12, 64, 1), ("convection_folded_pt_f64", (3072, 1024)): (8, 32, 1),
    ("convection_folded_pt_lean_f32", (3072, 1024)): (12, 64, 1),
    ("convection_folded_pt_lean_f64", (3072, 1024)): (8, 32, 1),
}
#: FDTD's cells, which the tile pass updates in place with the halo of
#: their one-sided reach: their law's geometry (tiling.REACH_LAW).
IN_PLACE_GEOMETRY = {
    (op, (side, side)): {"fdtd_coef": (40, 112, 8), "fdtd_lut": (32, 88, 4), "fdtd_render": (56, 80, 8)}[op]
    for op in ("fdtd_coef", "fdtd_lut", "fdtd_render") for side in (1024, 2048)
}


#: Convection's straight pseudo-transient cells, which the tile pass updates
#: in place with the halo of their declared reach (2p): their reach law's
#: geometry (tiling.REACH_LAW, 88 B in float64, 44 B in float32), the same
#: for the lean and the full functor; before it, the in-place law's 28x52
#: and 32x86 at p=2 (halo 3p), and before that 16x32 (lean) and 8x64 (full)
#: at p=2 in float64, 24x64 and 8x128 in float32, ping-pong.
CONVECTION_IN_PLACE_GEOMETRY = {
    (f"convection_{kind}_{width}", (3072, 1024)): {"f64": (28, 52, 3), "f32": (38, 80, 4)}[width]
    for kind in ("pt", "pt_lean") for width in ("f32", "f64")
}


def _tiling_geometry(op, shape):
    """The tile pass's (tile_h, tile_w, p) for functor ``op`` on ``shape`` at
    200 iterations a call, as the tiling backend picks it on an H100."""
    from stencilstream_tpu_torch.backends.tiling import pick_config

    cell, tf, _, _ = _case(op, (2, 2), 0, "cpu")
    return pick_config(*shape, tf.stencil_radius, tf.n_subiterations, 200, cuda_lib.tile_cell_smem_bytes(cell, tf),
                       cuda_lib.H100_SXM, in_place=cuda_lib.tile_writes(tf) is not None,
                       reach=cuda_lib.tile_reach(tf))


def test_every_functor_has_a_tiling_geometry_here():
    """The two tables name every functor at the sizes tile_sweep.py uses."""
    named = {op for op, _ in PING_PONG_GEOMETRY} | {op for op, _ in IN_PLACE_GEOMETRY} | {
        op for op, _ in CONVECTION_IN_PLACE_GEOMETRY}
    assert named == set(ALL_OPS + CONVECTION_OPS)


@pytest.mark.parametrize("op,shape", list(PING_PONG_GEOMETRY), ids=lambda v: str(v))
def test_functors_without_a_write_mask_keep_their_tile_geometry(op, shape):
    cell, tf, _, _ = _case(op, (2, 2), 0, "cpu")
    assert cuda_lib.tile_writes(tf) is None and cuda_lib.tile_reach(tf) is None
    assert cuda_lib.tile_cell_smem_bytes(cell, tf) == cuda_lib.cell_smem_bytes(cell, tf)
    assert _tiling_geometry(op, shape) == PING_PONG_GEOMETRY[op, shape]


@pytest.mark.parametrize("op,shape", list(IN_PLACE_GEOMETRY), ids=lambda v: str(v))
def test_in_place_cells_take_their_own_law(op, shape):
    """FDTD's cells, in place with a declared reach, take the reach law's
    entry, whose halo is p (the reach summed over a pass, 1 an iteration)."""
    from stencilstream_tpu_torch.backends.tiling import law_entry

    cell, tf, _, _ = _case(op, (2, 2), 0, "cpu")
    (th, tw), halo, _ = law_entry(cuda_lib.tile_cell_smem_bytes(cell, tf), in_place=True, reach=True)
    assert tp.pass_halo(1, 1, 2, cuda_lib.tile_reach(tf)) == 1
    assert _tiling_geometry(op, shape) == IN_PLACE_GEOMETRY[op, shape] == (th, tw, halo)


@pytest.mark.parametrize("op,shape", list(CONVECTION_IN_PLACE_GEOMETRY), ids=lambda v: str(v))
def test_convection_in_place_cells_take_the_in_place_law(op, shape):
    """Convection's straight pseudo-transient cells, in place with a
    declared reach, hold one plane per field (88 B in float64, 44 B in
    float32) and take the reach law's entry for those bytes (the in-place
    law of cells with a declared reach), whose halo is 2p at k=3; a call of
    one iteration (the full update's) runs the same tile at p=1, halo 2."""
    from stencilstream_tpu_torch.backends.tiling import REACH_LAW, law_entry, pick_config

    cell, tf, _, _ = _case(op, (2, 2), 0, "cpu")
    cell_bytes = cuda_lib.tile_cell_smem_bytes(cell, tf)
    reach = cuda_lib.tile_reach(tf)
    assert cell_bytes == (88 if op.endswith("f64") else 44) and reach == ((0, 1), (1, 0), (1, 1))
    assert law_entry(cell_bytes, in_place=True, reach=True) == REACH_LAW[cell_bytes]
    (th, tw), halo, _ = REACH_LAW[cell_bytes]
    assert _tiling_geometry(op, shape) == CONVECTION_IN_PLACE_GEOMETRY[op, shape] == (th, tw, halo // 2)
    assert tp.pass_halo(1, halo // 2, 3, reach) == halo
    assert pick_config(*shape, 1, 3, 1, cell_bytes, cuda_lib.H100_SXM, in_place=True, reach=reach) == (th, tw, 1)


def test_fdtds_in_place_and_reach_laws_keep_their_entries():
    """Convection's entries (44 B, 88 B) in the in-place law, which
    ``distributed`` and ``ring`` keep for its cells, and in the reach law,
    which ``tiling`` takes, leave FDTD's cells (16, 20 and 32 B) the entries
    they had, in both laws."""
    from stencilstream_tpu_torch.backends.tiling import REACH_LAW, law_entry

    assert [law_entry(b, in_place=True) for b in (16, 20, 32)] == [((32, 96), 8, 2), ((32, 96), 8, 2),
                                                                     ((32, 128), 8, 1)]
    assert [law_entry(b, in_place=True, reach=True) for b in (16, 20, 32)] == [((56, 80), 8, 2), ((32, 88), 4, 2),
                                                                                 ((40, 112), 8, 1)]
    assert [law_entry(b, in_place=True) for b in (44, 88)] == [((32, 86), 6, 1), ((28, 52), 6, 1)]
    assert [law_entry(b, in_place=True, reach=True) for b in (44, 88)] == [REACH_LAW[44], REACH_LAW[88]]
    assert sorted(REACH_LAW) == [16, 20, 32, 44, 88]


#: FDTD's geometry on the multi-device paths, which keep their stored halo
#: r*p*k and size their tiles by it (IN_PLACE_LAW): the tile at the p they
#: are given, as before the functors declared their reach.
MULTI_DEVICE_FDTD_GEOMETRY = {
    ("fdtd_coef", "distributed"): (32, 128), ("fdtd_lut", "distributed"): (32, 96),
    ("fdtd_render", "distributed"): (32, 96), ("fdtd_coef", "ring"): (32, 128),
    ("fdtd_lut", "ring"): (32, 96), ("fdtd_render", "ring"): (32, 96),
}


@pytest.mark.parametrize("op,backend", list(MULTI_DEVICE_FDTD_GEOMETRY), ids=lambda v: str(v))
def test_multi_device_fdtd_keeps_its_tile_geometry(op, backend):
    """``distributed`` ((2, 2) shards of 2048^2, p=4) and ``ring`` (chunks of
    256 rows, p=2) pick FDTD's tile as they did before its reach: by the
    symmetric halo r*p*k and IN_PLACE_LAW."""
    from stencilstream_tpu_torch.backends.tiling import pick_config

    cell, tf, _, _ = _case(op, (2, 2), 0, "cpu")
    shape, p = ((1024, 1024), 4) if backend == "distributed" else ((256, 2048), 2)
    got = pick_config(*shape, 1, 2, 200, cuda_lib.tile_cell_smem_bytes(cell, tf), cuda_lib.H100_SXM, p,
                      in_place=cuda_lib.tile_writes(tf) is not None)
    assert got == (*MULTI_DEVICE_FDTD_GEOMETRY[op, backend], p)


@pytest.mark.parametrize("resolver,tile_bytes", [("coef", 32), ("lut", 20), ("render", 16)])
def test_fdtd_tile_pass_holds_one_plane_per_field(resolver, tile_bytes):
    """FDTD's sub-steps write ex and ey, then hz and hz_sum, in place: the
    tile pass holds one plane per variant field and per invariant field
    (4 + NI planes of 4 B), the resident grid still two per variant field;
    narrow storage's functor declares no writes."""
    cell, tf, _, _ = _case(f"fdtd_{resolver}", (2, 2), 0, "cpu")
    assert cuda_lib.tile_writes(tf) == (0b0011, 0b1100)
    assert cuda_lib.tile_cell_smem_bytes(cell, tf) == tile_bytes
    assert cuda_lib.cell_smem_bytes(cell, tf) == tile_bytes + 16
    assert tp.tile_smem_bytes(32, 128, 8, tile_bytes) == tile_bytes * (48 * 144 + 16)
    if resolver == "coef":
        cell, tf, _, _ = _case("fdtd_coef__bf16", (2, 2), 0, "cpu")
        assert cuda_lib.tile_writes(tf) is None and cuda_lib.tile_cell_smem_bytes(cell, tf) == 24


#: The straight pseudo-transient functors, which the tile pass runs in place
#: (their transition function's ``cuda_writes``; the functor's ``kWrites``).
IN_PLACE_CONVECTION_OPS = [f"convection_{kind}_{width}" for kind in ("pt", "pt_lean") for width in ("f32", "f64")]
#: The masks of their sub-steps, bit j for ``cuda_variant[j]`` (Pt, Vx, Vy,
#: tau_xx, tau_yy, sigma_xy, dVxd_tau, dVyd_tau, then ErrV, ErrP).
CONVECTION_WRITES = {"pt": (0b1100111001, 0b0011000110, 0b1100000110), "pt_lean": (0b111001, 0b11000110, 0b110)}
#: (grid shape, active region (nx, ny)) of the twins' sub-step checks: the
#: grid less its last row and column, a region smaller than the grid, and
#: the smallest region the functor takes.
CONTRACT_REGIONS = [((12, 17), (11, 16)), ((14, 13), (9, 7)), ((6, 7), (3, 3))]


@pytest.mark.parametrize("shape,active", CONTRACT_REGIONS, ids=lambda v: "x".join(map(str, v)))
@pytest.mark.parametrize("op", IN_PLACE_CONVECTION_OPS)
def test_convection_sub_steps_change_their_writes_and_read_them_at_the_cell(op, shape, active):
    """The contract of the in-place map, on the Python twin one sub-step at
    a time over random fields: sub-step s changes exactly the fields of
    ``cuda_writes[s]``, and reads a field it changes only at the cell
    itself, but for sub-step 2's boundary copies (Vx from column 1 into
    column 0 and from ny - 2 into ny - 1, Vy from row 1 into row 0 and from
    nx - 2 into nx - 1), which read cells the sub-step leaves unchanged.
    Each written field is moved at every third row and column in turn: a
    cell off that lattice whose outputs move reads the moved cell of its
    3x3 neighbourhood."""
    from stencilstream_tpu_torch.backends.reference import single_subiteration

    cell, tf, halo = convection_case(op, shape, np.random.default_rng(41), "cpu", active)
    nx, ny = active
    assert cuda_lib.tile_writes(tf) == CONVECTION_WRITES[op[len("convection_"):-len("_f32")]]
    rows, cols = np.indices(shape)
    allowed = {("Vx", 0, 1): cols == 0, ("Vx", 0, -1): cols == ny - 1,
               ("Vy", 1, 0): rows == 0, ("Vy", -1, 0): rows == nx - 1}
    for sub, written in enumerate(tf.cuda_writes):
        def step(c):
            return single_subiteration(c, tf, halo, 0, sub, None, radius=1)

        new = step(cell)
        changed = {f for f in convection.FIELDS if not torch.equal(getattr(new, f), getattr(cell, f))}
        assert changed == set(written), sub
        for f in written:
            for a, b in np.ndindex(3, 3):
                lattice = (rows % 3 == a) & (cols % 3 == b)
                moved = dataclasses.replace(cell, **{f: getattr(cell, f) + torch.tensor(lattice)})
                out = step(moved)
                reads = ~lattice & np.any([(getattr(out, g) != getattr(new, g)).numpy()
                                           for g in convection.FIELDS], axis=0)
                # The offset of the moved cell in each reading cell's neighbourhood.
                dr, dc = (a - rows + 1) % 3 - 1, (b - cols + 1) % 3 - 1
                for x, y in zip(*np.nonzero(reads)):
                    key = (f, int(dr[x, y]), int(dc[x, y]))
                    assert sub == 2 and key in allowed and allowed[key][x, y], (sub, key, (x, y))
                    read = (x + key[1], y + key[2])
                    assert getattr(new, f)[read] == getattr(cell, f)[read], (sub, key, (x, y))


@pytest.mark.parametrize("shape,active", CONTRACT_REGIONS, ids=lambda v: "x".join(map(str, v)))
@pytest.mark.parametrize("op", IN_PLACE_CONVECTION_OPS)
def test_convection_sub_steps_read_within_their_declared_reach(op, shape, active):
    """The contract of the reach halo, on the Python twin one sub-step at a
    time over random fields: every field, T included, is moved at every
    third row and column in turn, and a cell off that lattice whose outputs
    move reads the moved cell of its 3x3 neighbourhood, which lies within
    the sub-step's declared reach (``cuda_reach``: lo rows and columns below
    the cell, hi above). The reach is no wider than the reads: sub-step 0
    reads above the cell, sub-step 1 below, sub-step 2 on both sides."""
    from stencilstream_tpu_torch.backends.reference import single_subiteration

    cell, tf, halo = convection_case(op, shape, np.random.default_rng(48), "cpu", active)
    rows, cols = np.indices(shape)
    read = [set() for _ in range(tf.n_subiterations)]
    for sub in range(tf.n_subiterations):
        def step(c):
            return single_subiteration(c, tf, halo, 0, sub, None, radius=1)

        new = step(cell)
        for a, b in np.ndindex(3, 3):
            lattice = (rows % 3 == a) & (cols % 3 == b)
            out = step(dataclasses.replace(cell, **{f: getattr(cell, f) + torch.tensor(lattice)
                                                    for f in convection.FIELDS}))
            reads = ~lattice & np.any([(getattr(out, g) != getattr(new, g)).numpy() for g in convection.FIELDS],
                                      axis=0)
            dr, dc = (a - rows + 1) % 3 - 1, (b - cols + 1) % 3 - 1
            read[sub] |= {(int(dr[x, y]), int(dc[x, y])) for x, y in zip(*np.nonzero(reads))}
    offsets = [{d for pair in sub for d in pair} for sub in read]
    assert cuda_lib.tile_reach(tf) == tuple((max(0, -min(o)), max(0, max(o))) for o in offsets)
    assert cuda_lib.tile_reach(tf) == ((0, 1), (1, 0), (1, 1))


@pytest.mark.parametrize("op", IN_PLACE_CONVECTION_OPS)
def test_convections_reach_twin_is_its_functors_declaration(op):
    """Convection's straight pseudo-transient sub-steps read one-sided but
    for sub-step 2: the reach the CPU side sizes the halo from
    (``cuda_reach``) is the one ``ConvectionPtOp`` declares to the kernel
    (``csrc/ops/convection.cuh``: ``kReach``), so the pass's halo is 2p,
    not r*p*k = 3p."""
    source = (cuda_lib.CSRC / "ops" / "convection.cuh").read_text()
    declared = re.search(r"Reach kReach\[kSubiterations\] = \{(.*)\};", source)
    pairs = tuple(tuple(int(v) for v in pair) for pair in re.findall(r"\{(\d+), (\d+)\}", declared.group(1)))
    _, tf, _ = convection_case(op, (8, 8), np.random.default_rng(0), "cpu")
    reach = cuda_lib.tile_reach(tf)
    assert reach == pairs == ((0, 1), (1, 0), (1, 1))
    assert [tp.pass_halo(1, p, 3, reach) for p in (1, 2, 3, 4)] == [2, 4, 6, 8]


@pytest.mark.parametrize("active", [(2, 5), (5, 2), (1, 1)], ids=lambda v: "x".join(map(str, v)))
@pytest.mark.parametrize("op", ["convection_pt_f64", "convection_pt_lean_f32"])
def test_convection_functor_refuses_an_active_region_under_3x3(op, active):
    """Sub-step 2's boundary copies would read cells that other lanes of the
    in-place map change: the transition function gives its functor no such
    region."""
    _, tf, _ = convection_case(op, (6, 7), np.random.default_rng(42), "cpu", active)
    with pytest.raises(ValueError, match="3x3"):
        tf.cuda_params()
    _, tf, _ = convection_case(op, (6, 7), np.random.default_rng(42), "cpu", (3, 3))
    assert tf.cuda_params()[:2] == (3, 3)


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


#: (shape, q) for the resident grid's band algebra (as tests/
#: test_torch_monotile.py:BAND_CASES): one-row bands, 8-row bands with a
#: ragged last band of 6 rows, 5-row bands.
MONO_BANDS = [((37, 53), 1), ((1030, 64), 1), ((1030, 64), 2), ((1030, 64), 4),
              ((600, 40), 1), ((600, 40), 2), ((600, 40), 4)]


def _band_plan(shape, q, limits, band=None):
    """A one-CTA-per-SM plan with ``q`` sub-steps per exchange."""
    band = band or -(-shape[0] // limits.sm_count)
    return mt.MonotilePlan(band, -(-shape[0] // band), 0, q, mt.MAX_THREADS)


#: (op, shape, q) of the band checks: the probe, HotSpot, Jacobi5, the
#: functors with a time-dependent value and the narrow instantiations on
#: every band shape, but for those
#: where q*r exceeds the band (the radius-2 probe's one-row and 5-row bands
#: at q >= 1 and 4).
BAND_CASES = [
    (op, shape, q)
    for op in ["hotspot", "jacobi5_general", "probe", *TDV_OPS, *NARROW_OPS]
    for shape, q in MONO_BANDS
    if q * (2 if op == "probe_radius2" else 1) <= -(-shape[0] // 132)
]


@pytest.mark.gpu
@pytest.mark.parametrize("op,shape,q", BAND_CASES, ids=[f"{op}-{h}x{w}-q{q}" for op, (h, w), q in BAND_CASES])
def test_monotile_bands_match_plain_version(cuda, op, shape, q):
    """n=5 (the k=2 functors n=3) from iteration 3, so that the last group of
    q sub-steps is short for q=2 and 4 (but for k=2 at q=2)."""
    cell, tf, halo, tol = _case(op, shape, 21, cuda, iteration=3)
    n = 3 if tf.n_subiterations == 2 else 5
    plan = _band_plan(shape, q, cuda_lib.device_limits(cuda))
    before = mt.launches
    got = mt.monotile(cell, tf, halo, offset=3, n_iterations=n, plan=plan)
    want = mt.monotile_plain(cell, tf, halo, offset=3, n_iterations=n)
    torch.cuda.synchronize()
    assert mt.launches == before + 1
    assert _max_err(got, want) <= tol
    if op in PROBES:
        assert int(got.status.abs().max()) == probe.NORMAL


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["hotspot", "probe", "probe_tdv", "fdtd_render"])
def test_monotile_single_cta(cuda, op):
    """One CTA holds the whole grid: no neighbour to wait for."""
    cell, tf, halo, tol = _case(op, (37, 53), 22, cuda, iteration=2)
    plan = _band_plan((37, 53), 4, cuda_lib.device_limits(cuda), band=37)
    assert plan.n_ctas == 1
    got = mt.monotile(cell, tf, halo, offset=2, n_iterations=7, plan=plan)
    want = mt.monotile_plain(cell, tf, halo, offset=2, n_iterations=7)
    torch.cuda.synchronize()
    assert _max_err(got, want) <= tol


@pytest.mark.gpu
def test_monotile_refuses_a_deep_halo_beyond_the_band(cuda):
    cell, tf, halo, _ = _case("hotspot", (1030, 64), 0, cuda)
    with pytest.raises(RuntimeError, match="resident-grid kernel"):
        mt.monotile(cell, tf, halo, offset=0, n_iterations=1, plan=_band_plan((1030, 64), 9, cuda_lib.device_limits(cuda)))


@pytest.mark.gpu
@pytest.mark.parametrize("op,shape", [("hotspot", (1024, 1024)), ("jacobi5_general", (1024, 1024)),
                                      ("probe", (600, 600))])
def test_monotile_residency_meets_the_plan(cuda, op, shape):
    """The CUDA occupancy calculator keeps the CTAs per SM the plan counts
    on at its band, q and threads."""
    cell, tf, _, _ = _case(op, shape, 0, cuda)
    plan = mt.monotile_plan(*shape, tf.stencil_radius, cuda_lib.cell_smem_bytes(cell, tf),
                            cuda_lib.device_limits(cuda))
    assert mt.monotile_residency(tf, plan, shape[1], cuda) >= mt.MAX_THREADS // plan.threads


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
        tp.tile_pass(strided, kernel, halo, i_start=0, offset=0, n_iterations=1, iters_per_pass=1,
                     tile=(16, 32))
    big = _cell((4096, 4096), 0, cuda)
    with pytest.raises(ValueError, match="tiling"):
        mt.monotile(big, kernel, halo, offset=0, n_iterations=1)


#: (shape, strip, panel, segment, p, i_start, offset, n): odd shapes, a grid
#: smaller than one strip and one panel, segment boundaries off the strip
#: grid, a pass with 1 of p steps active.
LINE_CACHE_CASES = [
    ((37, 53), 8, 32, 16, 3, 3, 3, 5),
    ((37, 53), 32, 64, 64, 4, 7, 3, 5),
    ((20, 24), 32, 64, 32, 8, 0, 0, 8),
    ((300, 260), 32, 64, 100, 8, 2, 1, 20),
    ((300, 260), 8, 32, 21, 5, 2, 1, 20),
]


#: The line-cache kernel's geometry, as chip_smoke.py checks it on every
#: functor: interior panels beside edge panels at widths that are and are
#: not multiples of 4; a ragged last strip; segments that end mid-strip, and
#: segments shorter than the warm-up, so that each starts inside the warm-up
#: of the one below; the law's strip and panel; p=1; 1 of p steps active.
_LAW = lc.pick_linecache_config(8192, 8192, 1, 1, 8, 4, 0, cuda_lib.H100_SXM)  # Jacobi5's
LINE_CACHE_GEOMETRY = [
    ((203, 1001), 32, 112, 64, 8, 0, 0, 8),
    ((200, 1008), 32, 112, 100, 8, 2, 1, 20),
    ((150, 1000), 64, 48, 20, 8, 0, 0, 8),
    ((300, 260), _LAW.strip_rows, _LAW.panel_cols, 128, 8, 0, 0, 8),
    ((45, 70), 8, 32, 16, 1, 4, 4, 1),
    ((45, 70), 16, 48, 24, 4, 7, 3, 5),
]


def _fitted_line(strip, panel, p, cell, tf, limits):
    """The case's panel and p, p halved and then the panel narrowed by a warp
    until the CTA fits one block (the probe's 20 B of variant fields need
    it)."""
    variant, invariant = cuda_lib.cell_field_bytes(cell, tf)
    while lc.line_cache_smem_bytes(strip, panel, tf.stencil_radius, p * tf.n_subiterations, variant,
                                   invariant) > limits.smem_per_block:
        p, panel = (p // 2, panel) if p > 1 else (p, max(lc.WARP, panel - lc.WARP))
    return panel, p


@pytest.mark.gpu
@pytest.mark.parametrize("case", LINE_CACHE_CASES + LINE_CACHE_GEOMETRY,
                         ids=lambda c: "x".join(map(str, c[0])) + f"-p{c[4]}-s{c[1]}-w{c[2]}-g{c[3]}")
@pytest.mark.parametrize("op", ["hotspot", "jacobi5_general", "conway", "probe"])
def test_line_cache_kernel_matches_plain_version(cuda, op, case):
    shape, strip, panel, segment, p, i_start, offset, n = case
    cell, tf, halo, tol = _case(op, shape, 11, cuda, iteration=i_start)
    panel, p = _fitted_line(strip, panel, p, cell, tf, cuda_lib.device_limits(cuda))
    kw = dict(i_start=i_start, offset=offset, n_iterations=n, iters_per_pass=p)
    before = lc.launches
    got = lc.line_cache_pass(cell, tf, halo, strip_rows=strip, panel_cols=panel, segment_rows=segment, **kw)
    want = lc.line_cache_pass_plain(cell, tf, halo, **kw)
    torch.cuda.synchronize()
    assert lc.launches == before + 1
    assert _max_err(got, want) <= tol
    if op == "hotspot":
        assert got.power is cell.power
    if op == "probe":
        assert int(got.status.abs().max()) == probe.NORMAL


@pytest.mark.gpu
@pytest.mark.parametrize("case", LINE_CACHE_GEOMETRY,
                         ids=lambda c: "x".join(map(str, c[0])) + f"-p{c[4]}-s{c[1]}-w{c[2]}-g{c[3]}")
@pytest.mark.parametrize("op", ALL_OPS)
def test_line_cache_geometry_on_every_functor(cuda, op, case):
    shape, strip, panel, segment, p, i_start, offset, n = case
    cell, tf, halo, tol = _case(op, shape, 14, cuda, iteration=i_start)
    panel, p = _fitted_line(strip, panel, p, cell, tf, cuda_lib.device_limits(cuda))
    kw = dict(i_start=i_start, offset=offset, n_iterations=n, iters_per_pass=p)
    before = lc.launches
    got = lc.line_cache_pass(cell, tf, halo, strip_rows=strip, panel_cols=panel, segment_rows=segment, **kw)
    want = lc.line_cache_pass_plain(cell, tf, halo, **kw)
    torch.cuda.synchronize()
    assert lc.launches == before + 1
    assert _max_err(got, want) <= tol
    if op in PROBES:
        assert int(got.status.abs().max()) == probe.NORMAL


@pytest.mark.gpu
def test_line_cache_refuses_a_geometry_the_kernel_cannot_take(cuda):
    cell, tf, halo, _ = _case("jacobi5_general", (64, 64), 0, cuda)
    kw = dict(i_start=0, offset=0, n_iterations=1, iters_per_pass=1, segment_rows=32)
    for strip, panel in ((12, 64), (32, 16)):
        with pytest.raises(ValueError, match="strip_rows|panel_cols"):
            lc.line_cache_pass(cell, tf, halo, strip_rows=strip, panel_cols=panel, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("op", ALL_OPS)
def test_every_functor_on_every_kernel(cuda, op):
    cell, tf, halo, tol = _case(op, (45, 70), 12, cuda, iteration=1)
    kw = dict(i_start=1, offset=1, n_iterations=5, iters_per_pass=3)
    want = tp.tile_pass_plain(cell, tf, halo, **kw)
    got = tp.tile_pass(cell, tf, halo, tile=(16, 32), **kw)
    assert _max_err(got, want) <= tol
    got = lc.line_cache_pass(cell, tf, halo, strip_rows=8, panel_cols=32, segment_rows=20, **kw)
    assert _max_err(got, want) <= tol
    got = mt.monotile(cell, tf, halo, offset=1, n_iterations=4)
    want = mt.monotile_plain(cell, tf, halo, offset=1, n_iterations=4)
    torch.cuda.synchronize()
    assert _max_err(got, want) <= tol
    if op == "conway":
        assert got.dtype == torch.bool
    if op in PROBES:
        assert int(got.status.abs().max()) == probe.NORMAL


#: (shape, tile, p, i_start, offset, n) for the tile-pass kernel's geometry:
#: interior tiles beside edge tiles whose core lies inside the grid but whose
#: window does not; widths that are not multiples of 4 (the copy widths); a
#: window height that leaves a ragged run; more tiles than resident CTAs;
#: p=1; a pass with 1 of p steps active.
TILE_CASES = [
    ((192, 288), (64, 96), 8, 0, 0, 8),
    ((61, 1001), (32, 64), 3, 2, 1, 20),
    ((70, 1002), (20, 32), 8, 0, 0, 8),
    ((1000, 1003), (8, 32), 2, 0, 0, 2),
    ((45, 70), (16, 32), 1, 4, 4, 1),
    ((45, 70), (16, 32), 4, 7, 3, 5),
]


def _fitted(tile, p, cell, tf, limits):
    """The case's tile and p, p halved and then the core's height halved until
    the window fits one block (the probe's 40 B cells need it)."""
    cell_bytes = cuda_lib.cell_smem_bytes(cell, tf)
    while tp.tile_smem_bytes(*tile, tf.stencil_radius * p * tf.n_subiterations, cell_bytes) > limits.smem_per_block:
        tile, p = (tile, p // 2) if p > 1 else ((max(tp.RUN_ROWS, tile[0] // 2), tile[1]), p)
    return tile, p


@pytest.mark.gpu
@pytest.mark.parametrize("case", TILE_CASES, ids=lambda c: "x".join(map(str, c[0])) + f"-t{c[1][0]}x{c[1][1]}-p{c[2]}")
@pytest.mark.parametrize("op", ALL_OPS)
def test_tile_pass_geometry_on_every_functor(cuda, op, case):
    shape, tile, p, i_start, offset, n = case
    cell, tf, halo, tol = _case(op, shape, 13, cuda, iteration=i_start)
    tile, p = _fitted(tile, p, cell, tf, cuda_lib.device_limits(cuda))
    kw = dict(i_start=i_start, offset=offset, n_iterations=n, iters_per_pass=p)
    before = tp.launches
    got = tp.tile_pass(cell, tf, halo, tile=tile, **kw)
    want = tp.tile_pass_plain(cell, tf, halo, **kw)
    torch.cuda.synchronize()
    assert tp.launches == before + 1
    assert _max_err(got, want) <= tol
    if op == "hotspot":
        assert got.power is cell.power
    if op in PROBES:
        assert int(got.status.abs().max()) == probe.NORMAL


#: The functors whose interior sub-steps take the vector thread map
#: (csrc/tile_pass.cu: vector_map): one 4-byte field, at most one invariant.
VECTOR_OPS = ["hotspot", *sorted(jacobi.VARIANTS)]
#: TILE_CASES, and windows that fill their pitch with the planes shifted by
#: 2 (tile width 44, halo 2: the first sub-step takes the scalar map) or by
#: 1 and 3 (width 42, halo 3), and the law's 56x112 at p=8.
VECTOR_CASES = TILE_CASES + [
    ((200, 300), (16, 44), 2, 0, 0, 2),
    ((200, 300), (16, 42), 3, 1, 0, 9),
    ((1024, 1024), (56, 112), 8, 0, 0, 8),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", VECTOR_CASES, ids=lambda c: "x".join(map(str, c[0])) + f"-t{c[1][0]}x{c[1][1]}-p{c[2]}")
@pytest.mark.parametrize("op", VECTOR_OPS)
def test_vector_map_matches_plain_version_bit_for_bit(cuda, op, case):
    """HotSpot and every Jacobi functor through the vector map's interior
    tiles (and the scalar map's edge tiles) equal the plain version exactly,
    and the launch counts as a vector-map launch."""
    shape, tile, p, i_start, offset, n = case
    cell, tf, halo, _ = _case(op, shape, 17, cuda, iteration=i_start)
    kw = dict(i_start=i_start, offset=offset, n_iterations=n, iters_per_pass=p)
    before = (tp.launches, tp.vector_launches)
    got = tp.tile_pass(cell, tf, halo, tile=tile, **kw)
    want = tp.tile_pass_plain(cell, tf, halo, **kw)
    torch.cuda.synchronize()
    assert (tp.launches, tp.vector_launches) == (before[0] + 1, before[1] + 1)
    assert _max_err(got, want) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["conway", "hotspot__bf16", "fdtd_coef", "probe", "convection_thermal_f32"])
def test_other_functors_keep_the_scalar_map(cuda, op):
    cell, tf, halo, _ = _case(op, (45, 70), 3, cuda)
    before = (tp.launches, tp.vector_launches)
    tp.tile_pass(cell, tf, halo, tile=(16, 32), i_start=0, offset=0, n_iterations=2, iters_per_pass=2)
    assert (tp.launches, tp.vector_launches) == (before[0] + 1, before[1])


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["hotspot", "jacobi5_general"])
def test_every_launch_of_a_tiling_call_takes_the_vector_map(cuda, op):
    """A tiling call at the law's geometry (2048^2, n=20: three passes)."""
    cell, tf, halo, _ = _case(op, (2048, 2048), 5, cuda)
    update = create_update(Params(transition_function=tf, n_iterations=20, halo_value=halo, blocking=True),
                           backend="tiling")
    before = (tp.launches, tp.vector_launches)
    update(Grid(cell))
    launches = tp.launches - before[0]
    assert launches == 3 and tp.vector_launches - before[1] == launches


#: The functors whose sub-steps the tile pass runs in place (csrc/tile_pass.cu:
#: in_place): FDTD's, for each material resolver.
IN_PLACE_OPS = ["fdtd_coef", "fdtd_lut", "fdtd_render"]
#: (shape, tile, p, i_start, offset, n) of the in-place map: the law's tile
#: on interior and edge tiles (its narrowed windows, 142 down to 128 columns,
#: are mostly not whole warps, so the ping-pong map shifts a chunk back);
#: a core 100 wide at p=6; 2048x2000, whose last column of tiles is 80 wide;
#: a partial pass (the call ends after 2 of the pass's 4 iterations, at an
#: odd offset); p=1 on a small grid.
IN_PLACE_CASES = [
    ((300, 212), (32, 128), 4, 0, 0, 4),
    ((300, 212), (16, 100), 6, 1, 1, 6),
    ((2048, 2000), (32, 128), 4, 0, 0, 4),
    ((300, 212), (32, 128), 4, 5, 3, 4),
    ((45, 70), (16, 32), 1, 4, 4, 1),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", IN_PLACE_CASES, ids=lambda c: "x".join(map(str, c[0])) + f"-t{c[1][0]}x{c[1][1]}-p{c[2]}")
@pytest.mark.parametrize("op", IN_PLACE_OPS)
def test_in_place_tile_pass_matches_plain_version_bit_for_bit(cuda, op, case):
    """FDTD's cells through the in-place sub-steps equal the plain version
    exactly, and the launch counts as an in-place one."""
    shape, tile, p, i_start, offset, n = case
    cell, tf, halo, _ = _case(op, shape, 19, cuda, iteration=i_start)
    kw = dict(i_start=i_start, offset=offset, n_iterations=n, iters_per_pass=p)
    before = (tp.launches, tp.inplace_launches, tp.vector_launches)
    got = tp.tile_pass(cell, tf, halo, tile=tile, **kw)
    want = tp.tile_pass_plain(cell, tf, halo, **kw)
    torch.cuda.synchronize()
    assert (tp.launches, tp.inplace_launches, tp.vector_launches) == (before[0] + 1, before[1] + 1, before[2])
    assert _max_err(got, want) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("shard", [(0, 0), (1, 1)])
@pytest.mark.parametrize("op", IN_PLACE_OPS)
def test_in_place_extended_pass_on_a_shard_of_a_2x2_mesh(cuda, op, shard):
    """Extended mode in place: one shard of a (2, 2) mesh over 300x212 with
    the pass's halo stored, at the law's tile and p=4, exactly."""
    (H, W), p = (300, 212), 4
    hp = 2 * p
    core = (H // 2, W // 2)
    origin = (shard[0] * core[0] - hp, shard[1] * core[1] - hp)
    cell, tf, halo, _ = _case(op, (core[0] + 2 * hp, core[1] + 2 * hp), 21, cuda, iteration=3)
    kw = dict(i_start=3, offset=3, n_iterations=2 * p, iters_per_pass=p, origin=origin, grid_range=(H, W),
              stored_halo=(hp, hp))
    got = tp.tile_pass(cell, tf, halo, tile=(32, 128), **kw)
    want = tp.tile_pass_plain(cell, tf, halo, **kw)
    torch.cuda.synchronize()
    assert cell_leaves(got)[0].shape == core
    assert _max_err(got, want) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("op", ALL_OPS + CONVECTION_OPS)
def test_in_place_launches_count_fdtd_only(cuda, op):
    """A functor's compiled write masks (``op_info``'s ``writes``) are its
    transition function's (``tile_writes``); only FDTD's float32 functors
    and convection's straight pseudo-transient ones have them, and only
    their launches count in ``inplace_launches``. The reach each sub-step
    declares (``op_info``'s ``reach``, the transition function's
    ``tile_reach``), and ``reach_launches``, are theirs alone too."""
    cell, tf, halo, _ = _case(op, (45, 70), 3, cuda)
    info = cuda_lib.op_info(cuda_lib.require_device_op(tf))
    in_place = op in IN_PLACE_OPS + IN_PLACE_CONVECTION_OPS
    assert info["writes"] == cuda_lib.tile_writes(tf)
    assert (info["writes"] is not None) == in_place
    reach = ((1, 0), (0, 1)) if op in IN_PLACE_OPS else ((0, 1), (1, 0), (1, 1)) if in_place else None
    assert info["reach"] == cuda_lib.tile_reach(tf) == reach
    tile, p = _fitted((16, 32), 1, cell, tf, cuda_lib.device_limits(cuda))
    before = (tp.inplace_launches, tp.reach_launches)
    tp.tile_pass(cell, tf, halo, tile=tile, i_start=0, offset=0, n_iterations=1, iters_per_pass=p)
    assert (tp.inplace_launches - before[0], tp.reach_launches - before[1]) == (in_place, in_place)


@pytest.mark.gpu
def test_every_launch_of_an_fdtd_tiling_call_is_in_place(cuda):
    """A tiling call at FDTD coef's law geometry (2048^2, n=17: three passes
    of p=8, the last partial), each launch in place and with the halo of
    the functor's declared reach."""
    cell, tf, halo, _ = _case("fdtd_coef", (2048, 2048), 5, cuda)
    update = create_update(Params(transition_function=tf, n_iterations=17, halo_value=halo, blocking=True),
                           backend="tiling")
    before = (tp.launches, tp.inplace_launches, tp.reach_launches)
    update(Grid(cell))
    assert (update.resolved_config["tile_rows"], update.resolved_config["tile_cols"],
            update.resolved_config["iters_per_pass"]) == IN_PLACE_GEOMETRY["fdtd_coef", (2048, 2048)]
    assert (tp.launches - before[0], tp.inplace_launches - before[1], tp.reach_launches - before[2]) == (3, 3, 3)


#: (shape, active region (nx, ny), tile, p, n) of convection's in-place
#: sub-steps, one pass of p from iteration 2 (n < p: a partial pass), each
#: with the halo of the declared reach, 2p: at 384x128 (res 128) tiles of
#: the in-place and reach laws' shapes and p = 1-4, interior tiles among
#: them, whose last rows and columns hold the boundaries nx - 1, nx and
#: ny - 1, ny; tiles whose edges fall on those boundaries (rows 31 | 32 and
#: columns 63 | 64 at 16x32 cores, both sides), and boundary rows and
#: columns nx - 1 = 16 and ny - 1 = 32 that open a core (sub-step 2 reads
#: below and left of them); every tile an edge tile; the smallest active
#: region, 3x3, inside a larger grid.
IN_PLACE_CONVECTION_CASES = [
    ((384, 128), None, (24, 52), 2, 2), ((384, 128), None, (28, 52), 1, 1), ((384, 128), None, (16, 46), 3, 3),
    ((384, 128), None, (16, 46), 3, 2), ((384, 128), None, (28, 52), 3, 3), ((384, 128), None, (28, 52), 3, 1),
    ((384, 128), None, (24, 48), 4, 4),
    ((33, 65), (32, 64), (16, 32), 2, 2), ((40, 72), (32, 64), (16, 32), 3, 3), ((40, 72), (33, 65), (16, 32), 1, 1),
    ((40, 72), (17, 33), (16, 32), 3, 3), ((40, 72), (17, 33), (8, 32), 2, 1),
    ((45, 70), (44, 69), (8, 32), 2, 2), ((9, 11), (3, 3), (16, 32), 3, 3), ((9, 11), (3, 3), (8, 32), 1, 1),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", IN_PLACE_CONVECTION_CASES,
                         ids=lambda c: "x".join(map(str, c[0])) + f"-a{c[1]}-t{c[2][0]}x{c[2][1]}-p{c[3]}-n{c[4]}")
@pytest.mark.parametrize("op", IN_PLACE_CONVECTION_OPS)
def test_in_place_convection_equals_resident_grid_and_plain_bit_for_bit(cuda, op, case):
    """Convection's straight pseudo-transient functors through the in-place
    sub-steps equal the plain version and the resident-grid kernel, which
    keeps the ping-pong map, exactly; the launch counts as an in-place one
    and as one of a declared reach."""
    shape, active, tile, p, n = case
    cell, tf, halo = convection_case(op, shape, np.random.default_rng(43), cuda, active)
    kw = dict(i_start=2, offset=2, n_iterations=n, iters_per_pass=p)
    before = (tp.launches, tp.inplace_launches, tp.reach_launches)
    got = tp.tile_pass(cell, tf, halo, tile=tile, **kw)
    assert (tp.launches, tp.inplace_launches, tp.reach_launches) == (before[0] + 1, before[1] + 1, before[2] + 1)
    want = tp.tile_pass_plain(cell, tf, halo, **kw)
    resident = mt.monotile(cell, tf, halo, offset=2, n_iterations=n)
    torch.cuda.synchronize()
    assert _max_err(got, want) == 0
    assert _max_err(got, resident) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("op", IN_PLACE_CONVECTION_OPS)
def test_in_place_convection_on_a_2x1_mesh(cuda, op):
    """``distributed`` on a (2, 1) mesh of the one card, 200x96, n = 5 from
    3 at p = 2 (a partial last pass): every shard's pass in place, with the
    stored halo r*p*k, exactly as ``reference``."""
    cell, tf, halo = convection_case(op, (200, 96), np.random.default_rng(44), cuda)
    params = Params(tf, halo_value=halo, iteration_offset=3, n_iterations=5)
    before = (tp.launches, tp.inplace_launches)
    got = create_update(params, backend="distributed", mesh=_mesh((2, 1), cuda), iters_per_pass=2)(Grid(cell))
    launched = (tp.launches - before[0], tp.inplace_launches - before[1])
    want = create_update(params, backend="reference")(Grid(cell))
    torch.cuda.synchronize()
    assert launched[0] > 0 and launched[1] == launched[0]
    assert _max_err(got.arrays, want.arrays) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("backend,mesh_shape", [("distributed", (2, 1)), ("ring", (2,))], ids=["distributed-2x1", "ring2"])
@pytest.mark.parametrize("op", IN_PLACE_CONVECTION_OPS)
def test_multi_device_convection_equals_tiling_bit_for_bit(cuda, op, backend, mesh_shape):
    """``distributed`` on a (2, 1) mesh and ``ring`` over two positions of
    the one card, 200x96, n = 7 from 3 at p = 3 (a partial last pass): they
    store the halo r*p*k = 9 and take the in-place law's tile, the kernel
    reads its reach halo 2p out of the stored one, and the result equals
    ``tiling``'s, at the reach law's tile and halo, bit for bit."""
    cell, tf, halo = convection_case(op, (200, 96), np.random.default_rng(47), cuda)
    params = Params(tf, halo_value=halo, iteration_offset=3, n_iterations=7)
    before = tp.reach_launches
    got = create_update(params, backend=backend, mesh=_mesh(mesh_shape, cuda), iters_per_pass=3)(Grid(cell))
    want = create_update(params, backend="tiling")(Grid(cell))
    torch.cuda.synchronize()
    assert tp.reach_launches > before
    assert _max_err(got.arrays, want.arrays) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("active", [(2, 5), (5, 2)], ids=lambda v: "x".join(map(str, v)))
@pytest.mark.parametrize("op", IN_PLACE_CONVECTION_OPS)
def test_in_place_convection_refuses_an_active_region_under_3x3(cuda, op, active):
    cell, tf, halo = convection_case(op, (9, 11), np.random.default_rng(45), cuda, active)
    before = tp.launches
    with pytest.raises(ValueError, match="3x3"):
        tp.tile_pass(cell, tf, halo, tile=(8, 32), i_start=0, offset=0, n_iterations=1, iters_per_pass=1)
    assert tp.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("op", IN_PLACE_CONVECTION_OPS)
def test_every_launch_of_a_convection_tiling_call_is_in_place(cuda, op):
    """A tiling call at the reach law's geometry for 3072x1024 (res 1024),
    n = 2p + 1 from 7 (the last pass partial): each launch in place with the
    halo of the declared reach, the result exactly ``reference``'s."""
    cell, tf, halo = convection_case(op, (3072, 1024), np.random.default_rng(46), cuda)
    th, tw, p = CONVECTION_IN_PLACE_GEOMETRY[op, (3072, 1024)]
    params = Params(tf, halo_value=halo, iteration_offset=7, n_iterations=2 * p + 1, blocking=True)
    update = create_update(params, backend="tiling")
    before = (tp.launches, tp.inplace_launches, tp.reach_launches)
    got = update(Grid(cell))
    assert (update.resolved_config["tile_rows"], update.resolved_config["tile_cols"],
            update.resolved_config["iters_per_pass"]) == (th, tw, p)
    assert (tp.launches - before[0], tp.inplace_launches - before[1], tp.reach_launches - before[2]) == (3, 3, 3)
    want = create_update(params, backend="reference")(Grid(cell))
    torch.cuda.synchronize()
    assert _max_err(got.arrays, want.arrays) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("p", [4, None], ids=["p4", "law"])
@pytest.mark.parametrize("side", [48, 1024, 2048])
@pytest.mark.parametrize("op", IN_PLACE_OPS)
def test_fdtd_tiling_at_the_reach_halo_matches_plain_version_bit_for_bit(cuda, op, side, p):
    """A tiling call of FDTD, whose functor declares its one-sided reach
    (halo p): 2p + 1 iterations from an offset that crosses the source's
    cutoff and the detect switch, the last pass partial, equals the plain
    version exactly; at 48^2 every tile is an edge tile, at 1024^2 and
    2048^2 most are interior. Every launch counts as a reach launch."""
    from stencilstream_tpu_torch.backends.tiling import pick_config

    cell, tf, halo, _ = _case(op, (side, side), 23, cuda, iteration=5)
    _, _, ipp = pick_config(side, side, 1, 2, 0, cuda_lib.tile_cell_smem_bytes(cell, tf),
                            cuda_lib.device_limits(cuda), p, in_place=True, reach=cuda_lib.tile_reach(tf))
    params = Params(transition_function=tf, halo_value=halo, iteration_offset=3, n_iterations=2 * ipp + 1,
                    blocking=True)
    kw = {} if p is None else {"iters_per_pass": p}
    before = (tp.launches, tp.reach_launches)
    update = create_update(params, backend="tiling", **kw)
    got = update(Grid(cell))
    want = create_update(params, backend="reference")(Grid(cell))
    torch.cuda.synchronize()
    assert update.resolved_config["iters_per_pass"] == ipp
    assert (tp.launches - before[0], tp.reach_launches - before[1]) == (3, 3)
    assert _max_err(got.arrays, want.arrays) == 0


@pytest.mark.gpu
def test_tile_pass_refuses_a_tile_the_thread_map_cannot_take(cuda):
    cell, tf, halo, _ = _case("hotspot", (64, 64), 0, cuda)
    kw = dict(i_start=0, offset=0, n_iterations=1, iters_per_pass=1)
    for tile in ((64, 16), (4, 64)):
        with pytest.raises(ValueError, match="tile"):
            tp.tile_pass(cell, tf, halo, tile=tile, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["hotspot", "jacobi5_general", "conway", "probe"])
def test_tile_pass_residency_meets_the_laws_count(cuda, op):
    """The CUDA runtime holds at least as many tile-pass CTAs per SM at the
    law's 8192^2 geometry as the law sized the window for."""
    from stencilstream_tpu_torch.backends.tiling import TILE_LAW, pick_config

    cell, tf, _, _ = _case(op, (2, 2), 0, "cpu")
    cell_bytes = cuda_lib.cell_smem_bytes(cell, tf)
    th, tw, p = pick_config(8192, 8192, tf.stencil_radius, tf.n_subiterations, 200, cell_bytes,
                            cuda_lib.device_limits(cuda))
    assert tp.tile_pass_residency(tf, (th, tw), p, cuda) >= TILE_LAW[cell_bytes][2]


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["jacobi5_general", "hotspot"])
def test_line_cache_residency_meets_the_laws_count(cuda, op):
    """The config law counts threads and shared memory only; the CUDA
    runtime, which counts registers as well, holds at least as many CTAs per
    SM at the law's 8192^2 geometry, so one wave holds the law's segments."""
    cell, tf, _, _ = _case(op, (2, 2), 0, "cpu")
    limits = cuda_lib.device_limits(cuda)
    variant, invariant = cuda_lib.cell_field_bytes(cell, tf)
    cfg = lc.pick_linecache_config(8192, 8192, 1, 1, 200, variant, invariant, limits)
    smem = lc.line_cache_smem_bytes(cfg.strip_rows, cfg.panel_cols, 1, cfg.iters_per_pass, variant, invariant)
    law = lc.ctas_per_sm(smem, limits, lc.law_entry(variant + invariant)[3])
    assert lc.line_cache_residency(tf, cfg.strip_rows, cfg.panel_cols, cfg.iters_per_pass, cuda) >= law


@pytest.mark.gpu
def test_linecache_mode_launches_only_the_line_cache_kernel(cuda):
    x = torch.tensor(np.random.default_rng(4).random((1000, 700), np.float32), device=cuda)
    kernel = jacobi.make_kernel("jacobi5_general", JACOBI_COEFS["jacobi5_general"])
    before = (lc.launches, tp.launches, mt.launches)
    got, update = jacobi.run(Grid(x), kernel, 13, backend="tiling", window_mode="linecache")
    launched = (lc.launches - before[0], tp.launches - before[1], mt.launches - before[2])
    assert update.resolved_config["window_mode"] == "linecache"
    assert launched == (2, 0, 0)  # p = 8: one full pass and one partial
    want, _ = jacobi.run(Grid(x), kernel, 13, backend="reference")
    assert float((got.arrays - want.arrays).abs().max()) <= 1e-5


# -- the time-dependent value on the card -------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("strategy", ["inline", "precompute_on_device", "precompute_on_host"])
@pytest.mark.parametrize("op", ["probe_tdv", "probe_radius2"])
def test_tdv_probe_reads_each_strategys_stream(cuda, op, strategy):
    """The probe checks its time-dependent value against the iteration in
    every cell. A call of n=5 from iteration 3 under each strategy: the
    tile pass and the line cache on the second pass of p=4 (1 of 4 steps
    active), the resident grid at q = 1, 2 and 4; every cell stays Normal
    and equals the plain version given the same stream. A stream shifted by
    one turns every cell Invalid, on the card as in the plain version."""
    offset, n = 3, 5
    cell, tf, halo, _ = _case(op, (45, 70), 16, cuda, iteration=7)
    stream = tdv_stream(tf, offset, n, cuda, strategy)
    assert stream.dtype == torch.int32 and stream.tolist() == list(range(offset, offset + n))
    kw = dict(i_start=7, offset=offset, n_iterations=n, iters_per_pass=4)
    want = tp.tile_pass_plain(cell, tf, halo, tdv=stream, **kw)
    for got in (tp.tile_pass(cell, tf, halo, tile=(16, 32), tdv=stream, **kw),
                lc.line_cache_pass(cell, tf, halo, strip_rows=8, panel_cols=32, segment_rows=20, tdv=stream, **kw)):
        torch.cuda.synchronize()
        assert _max_err(got, want) == 0 and int(got.status.abs().max()) == probe.NORMAL
        assert int(got.i_iteration.min()) == offset + n
    shifted = tp.tile_pass(cell, tf, halo, tile=(16, 32), tdv=stream + 1, **kw)
    assert bool((shifted.status == probe.INVALID).all())
    assert _max_err(shifted, tp.tile_pass_plain(cell, tf, halo, tdv=stream + 1, **kw)) == 0
    cell, tf, halo, _ = _case(op, (1030, 64), 17, cuda, iteration=offset)
    stream = tdv_stream(tf, offset, 3, cuda, strategy)
    want = mt.monotile_plain(cell, tf, halo, offset=offset, n_iterations=3, tdv=stream)
    for q in (1, 2, 4):
        plan = _band_plan((1030, 64), q, cuda_lib.device_limits(cuda))
        got = mt.monotile(cell, tf, halo, offset=offset, n_iterations=3, tdv=stream, plan=plan)
        torch.cuda.synchronize()
        assert _max_err(got, want) == 0 and int(got.status.abs().max()) == probe.NORMAL


@pytest.mark.gpu
def test_kernels_refuse_a_stream_they_cannot_read(cuda):
    cell, tf, halo, _ = _case("probe_tdv", (45, 70), 18, cuda, iteration=0)
    kw = dict(i_start=0, offset=0, n_iterations=4, iters_per_pass=2)
    for bad in (torch.arange(4, dtype=torch.float32, device=cuda), torch.arange(3, dtype=torch.int32, device=cuda),
                torch.arange(4, dtype=torch.int32)):
        with pytest.raises(ValueError, match="cannot be streamed"):
            tp.tile_pass(cell, tf, halo, tile=(16, 32), tdv=bad, **kw)
        with pytest.raises(ValueError, match="cannot be streamed"):
            mt.monotile(cell, tf, halo, offset=0, n_iterations=4, tdv=bad)


#: The FDTD paths of chip_smoke.py at a reduced n: (resolver, side, backend,
#: options, TDV strategy, the kernel it must launch).
FDTD_PATHS = [
    ("coef", 1024, "auto", {}, "inline", "tile_pass"),
    ("coef", 512, "auto", {}, "precompute_on_host", "monotile"),
    ("render", 1024, "tiling", {"window_mode": "linecache"}, "precompute_on_device", "line_cache"),
    ("lut", 1024, "auto", {}, "inline", "tile_pass"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("resolver,side,backend,kw,strategy,expect", FDTD_PATHS,
                         ids=[f"{r}-{s}-{b}-{e}" for r, s, b, _, _, e in FDTD_PATHS])
def test_fdtd_paths_launch_their_kernel(cuda, resolver, side, backend, kw, strategy, expect):
    """Twelve iterations across the detect iteration, through the backend a
    user calls: only the expected kernel launches, and the fields equal the
    reference backend's on the card."""
    p = _fdtd_parameters(side)
    res = fdtd.RESOLVERS[resolver](p)
    grid = fdtd.init_grid(p, res, device=cuda)
    counters = {"tile_pass": tp, "monotile": mt, "line_cache": lc}
    outs = {}
    for name in (backend, "reference"):
        update, _ = fdtd.build_simulation(p, res, backend=name, tdv_strategy=strategy, n_iterations=12, **(
            kw if name == backend else {}))
        update.get_params().iteration_offset = update.get_params().transition_function.detect_iteration - 6
        before = {k: m.launches for k, m in counters.items()}
        outs[name] = update(grid)
        launched = {k for k, m in counters.items() if m.launches != before[k]}
        assert launched == (set() if name == "reference" else {expect}), (name, launched)
    assert _max_err(outs[backend].arrays, outs["reference"].arrays) == 0
    assert float(outs[backend].arrays.hz_sum.abs().max()) > 0


# -- convection: float64 cells and ten variant fields on the card --------------

#: (shape, active region (nx, ny)): the mask rows nx-1, nx and columns ny-1,
#: ny on the boundaries of 16x32 tile cores, of 16-row segments and of
#: 8-row bands (33x65: 32 and 64); odd shapes; an active region smaller
#: than the grid.
CONVECTION_SHAPES = [((33, 65), (32, 64)), ((45, 70), (44, 69)), ((40, 72), (32, 64))]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,active", CONVECTION_SHAPES, ids=lambda v: "x".join(map(str, v)))
@pytest.mark.parametrize("op", CONVECTION_OPS)
def test_convection_functors_on_every_kernel(cuda, op, shape, active):
    """Exact against the plain versions: the tile pass at 16x32 cores, p=2
    from iteration 1 of a call of 5 from 1 (the second pass partial); the
    line cache at strips of 8 (one-row runs) or 16 (the thermal functor's
    8-row runs), panels of 32, segments of 16; the resident grid at q=1 and
    2 on 8-row bands, and the plan's geometry. The float64 folded cells
    (264 and 248 B of shared memory) take the tile pass at 8x32 cores and
    p=1, and 4-row bands where 8 rows do not fit one block. The straight
    pseudo-transient functors, in place with the halo of their reach (2p),
    also take the tile pass at p=3 on 16x32 cores, every tile an edge tile,
    the second pass partial."""
    cell, tf, halo = convection_case(op, shape, np.random.default_rng(31), cuda, active)
    limits = cuda_lib.device_limits(cuda)
    tile, p = _fitted((16, 32), 2, cell, tf, limits)
    for i_start in (1, 1 + p):
        kw = dict(i_start=i_start, offset=1, n_iterations=5, iters_per_pass=p)
        want = tp.tile_pass_plain(cell, tf, halo, **kw)
        before = (tp.launches, lc.launches)
        got = tp.tile_pass(cell, tf, halo, tile=tile, **kw)
        assert _max_err(got, want) == 0, ("tile_pass", i_start)
        strip = 16 if "thermal" in op else 8
        got = lc.line_cache_pass(cell, tf, halo, strip_rows=strip, panel_cols=32, segment_rows=16, **kw)
        torch.cuda.synchronize()
        assert _max_err(got, want) == 0, ("line_cache", i_start)
        assert (tp.launches, lc.launches) == (before[0] + 1, before[1] + 1)
    if op in IN_PLACE_CONVECTION_OPS:
        for i_start in (1, 4):
            kw = dict(i_start=i_start, offset=1, n_iterations=5, iters_per_pass=3)
            got = tp.tile_pass(cell, tf, halo, tile=(16, 32), **kw)
            assert _max_err(got, tp.tile_pass_plain(cell, tf, halo, **kw)) == 0, ("tile_pass p=3", i_start)
    want = mt.monotile_plain(cell, tf, halo, offset=1, n_iterations=3)
    cell_bytes = cuda_lib.cell_smem_bytes(cell, tf)
    bands = [8 if mt.monotile_smem_bytes(8, q, shape[1], 1, cell_bytes) <= limits.smem_per_block else 4
             for q in (1, 2)]
    for plan in (_band_plan(shape, 1, limits, band=bands[0]), _band_plan(shape, 2, limits, band=bands[1]), None):
        got = mt.monotile(cell, tf, halo, offset=1, n_iterations=3, plan=plan)
        torch.cuda.synchronize()
        assert _max_err(got, want) == 0, ("monotile", plan)
    assert got.T is cell.T if "pt" in op else got.Vx is cell.Vx


@pytest.mark.gpu
@pytest.mark.parametrize("op", CONVECTION_OPS)
def test_convection_partial_passes_through_tiling(cuda, op):
    """n = nerr - 1 = 49 at p=2 (24 full passes and a partial one; p=1 for
    the float64 folded cells, whose p=2 window fits no tile) through
    ``tiling`` in both window modes, and for the straight pseudo-transient
    functors at the reach law's geometry too (float64 p=3: 16 full passes
    and a partial one of one iteration; float32 p=4: 12 and one), against
    the reference backend on the card: exact. 384x128 (res 128), an
    iteration offset of 7."""
    from stencilstream_tpu_torch.backends.tiling import REACH_LAW

    cell, tf, halo = convection_case(op, (384, 128), np.random.default_rng(32), cuda)
    grid = Grid(cell)
    p = _fitted((8, 32), 2, cell, tf, cuda_lib.device_limits(cuda))[1]

    def update(backend, **kw):
        return create_update(Params(tf, halo_value=halo, iteration_offset=7, n_iterations=49), backend=backend, **kw)

    want = update("reference")(grid)
    kws = [{"iters_per_pass": p}, {"iters_per_pass": p, "window_mode": "linecache"}]
    for kw in kws + ([{}] if op in IN_PLACE_CONVECTION_OPS else []):
        before = (tp.launches, lc.launches)
        tiling = update("tiling", **kw)
        got = tiling(grid)
        ipp = tiling.resolved_config["iters_per_pass"]
        launched = (tp.launches - before[0], lc.launches - before[1])
        assert launched == ((0, -(-49 // ipp)) if "window_mode" in kw else (-(-49 // ipp), 0))
        assert ipp == (kw.get("iters_per_pass") or REACH_LAW[cuda_lib.tile_cell_smem_bytes(cell, tf)][1] // 2)
        assert _max_err(got.arrays, want.arrays) == 0, kw


@pytest.mark.gpu
def test_convection_refuses_a_grid_of_another_dtype(cuda):
    cell, tf, halo = convection_case("convection_pt_f32", (33, 65), np.random.default_rng(33), cuda)
    wide = convection.ThermalConvectionCell(**{f: getattr(cell, f).double() for f in convection.FIELDS})
    with pytest.raises(TypeError, match="float32"):
        tp.tile_pass(wide, tf, halo, tile=(16, 32), i_start=0, offset=0, n_iterations=1, iters_per_pass=1)
    with pytest.raises(TypeError, match="float32"):
        mt.monotile(wide, tf, halo, offset=0, n_iterations=1)


#: Tile-pass launches of a straight convection path at one block and one
#: thermal step, by dtype: the lean update's 49 iterations at the reach
#: law's p (4 in float32, 3 in float64; the last pass partial), one full
#: pass, one thermal pass.
STRAIGHT_TILE_PASS_LAUNCHES = {np.float32: 13 + 1 + 1, np.float64: 17 + 1 + 1}
#: The convection paths of chip_smoke.py at one block and one thermal step:
#: (res, dtype, backend, options, the kernel it must launch).
CONVECTION_PATHS = [
    (1024, np.float32, "auto", {}, "tile_pass"),
    (1024, np.float64, "auto", {}, "tile_pass"),
    (128, np.float64, "auto", {}, "monotile"),
    (1024, np.float32, "tiling", {"window_mode": "linecache"}, "line_cache"),
    (1024, np.float32, "auto", {"folded": True}, "tile_pass"),
    (1024, np.float64, "auto", {"folded": True}, "tile_pass"),
    (128, np.float64, "monotile", {"folded": True}, "monotile"),
    (1024, np.float32, "tiling", {"window_mode": "linecache", "folded": True}, "line_cache"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("res,dtype,backend,kw,expect", CONVECTION_PATHS,
                         ids=[f"{r}-{d.__name__}-{b}-{e}" + ("-folded" if kw.get("folded") else "")
                              for r, d, b, kw, e in CONVECTION_PATHS])
def test_convection_paths_launch_their_kernel(cuda, res, dtype, backend, kw, expect):
    """``convection.run`` of the JAX bench's experiment, cut to one block of
    nerr iterations and one thermal step, through the backend a user calls:
    only the expected kernel launches, and the grid and the statistics equal
    the reference backend's straight run on the card (a folded run's 11
    physics fields; its planes are the initial ones, untouched)."""
    e = dataclasses.replace(convection_experiment(res), iterMax=50, nt=1)
    counters = {"tile_pass": tp, "monotile": mt, "line_cache": lc}
    before = {k: m.launches for k, m in counters.items()}
    got, info = convection.run(e, backend=backend, dtype=dtype, verbose=False, device=cuda, **kw)
    launched = {k for k, m in counters.items() if m.launches != before[k]}
    assert launched == {expect}
    if expect == "tile_pass" and not kw.get("folded"):
        assert tp.launches - before["tile_pass"] == STRAIGHT_TILE_PASS_LAUNCHES[dtype]
    want, want_info = convection.run(e, backend="reference", dtype=dtype, verbose=False, device=cuda)
    assert info["stats"] == want_info["stats"]
    assert _max_err(convection.physics_cell(got.arrays), want.arrays) == 0
    if kw.get("folded"):
        planes = convection.init_folded_grid(e, dtype, device=cuda).arrays
        assert all(torch.equal(getattr(got.arrays, f), getattr(planes, f)) for f in convection.PLANES)


# -- narrow storage: bfloat16 and float8 e4m3 cells, float32 compute --------
# (Each narrow instantiation also runs every case of the geometry and band
# tests above, as one more entry of ALL_OPS and BAND_CASES.)


def _nan_err(a, b):
    """Largest absolute difference of two cells' fields: NaN on both sides
    counts as equal, on one side only as infinite."""
    def err(x, y):
        x, y = x.double(), y.double()
        d = (x - y).abs().nan_to_num(nan=float("inf"))
        return float(torch.where(x.isnan() & y.isnan(), 0.0, d).max())

    return max(err(x, y) for x, y in zip(cell_leaves(a), cell_leaves(b)))


def test_narrow_functors_are_instantiated_in_every_kernel():
    """ops/all.cuh's narrow list holds the pairs of cuda_lib.NARROW_OPS,
    named <functor>__<storage>, and every kernel source expands its entry
    macro over it."""
    text = (cuda_lib.CSRC / "ops" / "all.cuh").read_text()
    listed = re.findall(r"X\((\w+)__(\w+), ss::Narrow<ss::(\w+), ss::(\w+)>\)", text)
    kinds = {"Bf16": "bf16", "E4m3": "e4m3"}
    assert [f"{op}__{s}" for op, s, _, _ in listed] == NARROW_OPS
    assert {(op, _storage(s)) for op, s, _, _ in listed} == set(cuda_lib.NARROW_OPS)
    assert all(kinds[k] == s for _, s, _, k in listed)
    for src in cuda_lib.STENCIL_SOURCES:
        assert re.search(r"^SS_FOR_EACH_NARROW_OP\(SS_\w+_ENTRY\)$", (cuda_lib.CSRC / src).read_text(), re.M), src
    assert cuda_lib._DTYPES[(2, 2)] == torch.bfloat16 and cuda_lib._DTYPES[(1, 3)] == torch.float8_e4m3fn


def test_narrow_storage_names_its_instantiation_or_raises():
    """A wrapped transition function names <functor>__<storage>; a pair that
    is not built raises, naming it and the reference backend."""
    for op in NARROW_OPS:
        assert cuda_lib.require_device_op(_case(op, (2, 2), 0, "cpu")[1]) == op
    for op, dtype in (("hotspot", torch.float8_e4m3fn), ("conway", torch.bfloat16), ("fdtd_lut", torch.bfloat16)):
        tf = CastStorageKernel(_case(op, (2, 2), 0, "cpu")[1], dtype)
        with pytest.raises(NotImplementedError, match=f"{op}.*{dtype}.*reference"):
            cuda_lib.require_device_op(tf)


def test_narrow_cells_take_the_laws_by_their_bytes():
    """Shared-memory and traffic bytes follow the stored dtype, so the tile,
    line-cache and resident-grid laws and the bounds see the narrower cell:
    Jacobi5 2048^2 in bfloat16 fits the resident grid, in float32 it does
    not."""
    from stencilstream_tpu_torch.backends.auto import choose_backend

    for op, smem, traffic in (("jacobi5_general__bf16", 4, (2, 2)), ("hotspot__bf16", 6, (4, 2)),
                              ("fdtd_coef__bf16", 24, (16, 8)), ("jacobi5_general__e4m3", 2, (1, 1))):
        cell, tf, _, _ = _case(op, (2, 2), 0, "cpu")
        assert cuda_lib.cell_smem_bytes(cell, tf) == smem
        assert cuda_lib.cell_traffic_bytes(cell, tf) == traffic
    tf = jacobi.make_kernel("jacobi5_general", JACOBI_COEFS["jacobi5_general"])
    x = torch.zeros(2048, 2048)
    assert choose_backend(Grid(x), tf) == "tiling"
    assert choose_backend(Grid(cast_storage(x)), CastStorageKernel(tf)) == "monotile"


def test_mixed_storage_cells_have_no_kernel():
    """A functor has one element type: an int32 field beside bfloat16 ones
    is refused, naming the field and both dtypes."""
    cell = hs.HotspotCell(temp=torch.zeros(2, 2, dtype=torch.bfloat16), power=torch.zeros(2, 2, dtype=torch.int32))
    leaves = cell_leaves(cell)
    with pytest.raises(TypeError, match="'power' is torch.int32"):
        cuda_lib.check_field_dtypes("hotspot__bf16", torch.bfloat16, ("temp", "power"), leaves, leaves)
    cuda_lib.check_field_dtypes("hotspot__bf16", torch.bfloat16, ("temp", "power"), leaves[:1], leaves[:1])


@pytest.mark.gpu
@pytest.mark.parametrize("lo,hi", [(20, 260), (10, 150)])
def test_float8_overflow_is_nan_on_every_kernel(cuda, lo, hi):
    """Jacobi5 in float8 e4m3 with coefficients that sum to 2.5, two steps on
    values in [lo, hi] (the first overflows in [20, 260], the second in
    [10, 150]): results beyond 464 must come out NaN, as in the plain
    version (not saturated to 448), on all three kernels."""
    x = torch.tensor(np.random.default_rng(34).uniform(lo, hi, (96, 160)).astype(np.float32), device=cuda)
    cell = cast_storage(x, torch.float8_e4m3fn)
    tf = CastStorageKernel(jacobi.make_kernel("jacobi5_general", [0.5] * 5), torch.float8_e4m3fn)
    kw = dict(i_start=0, offset=0, n_iterations=2, iters_per_pass=2)
    want = tp.tile_pass_plain(cell, tf, 1.0, **kw)
    assert 0 < int(want.float().isnan().sum()) < want.numel()
    for got in (tp.tile_pass(cell, tf, 1.0, tile=(32, 64), **kw),
                lc.line_cache_pass(cell, tf, 1.0, strip_rows=16, panel_cols=64, segment_rows=32, **kw),
                mt.monotile(cell, tf, 1.0, offset=0, n_iterations=2)):
        torch.cuda.synchronize()
        assert _nan_err(got, want) == 0


#: The narrow paths of chip_smoke.py at reduced sizes: (op, side, backend,
#: options, the kernel it must launch). A bfloat16 Jacobi5 cell takes 4 B of
#: shared memory, so grids up to 2560^2 fit the resident grid and ``auto``
#: sends 3072^2 to the tile pass.
NARROW_PATHS = [
    ("jacobi5_general__bf16", 3072, "auto", {}, "tile_pass"),
    ("jacobi5_general__bf16", 2304, "tiling", {"window_mode": "linecache"}, "line_cache"),
    ("hotspot__bf16", 2304, "auto", {}, "tile_pass"),
    ("jacobi5_general__bf16", 1024, "auto", {}, "monotile"),
    ("jacobi5_general__e4m3", 2304, "tiling", {}, "tile_pass"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("op,side,backend,kw,expect", NARROW_PATHS,
                         ids=[f"{o}-{s}-{b}-{e}" for o, s, b, _, e in NARROW_PATHS])
def test_narrow_paths_launch_their_kernel(cuda, op, side, backend, kw, expect):
    """13 iterations through the backend a user calls launch the expected
    kernel only and equal the reference backend on the card."""
    cell, tf, halo, _ = _case(op, (side, side), 35, cuda)
    update = lambda b, **o: create_update(Params(tf, halo_value=halo, n_iterations=13), backend=b, **o)  # noqa: E731
    counters = {"tile_pass": tp, "monotile": mt, "line_cache": lc}
    before = {k: m.launches for k, m in counters.items()}
    got = update(backend, **kw)(Grid(cell))
    assert {k for k, m in counters.items() if m.launches != before[k]} == {expect}
    want = update("reference")(Grid(cell))
    assert _nan_err(got.arrays, want.arrays) == 0


# -- the tile pass in extended mode; distributed and ring on one card --------

#: The functors extended mode is held on: HotSpot (an invariant field), the
#: probe at radius 2 with its TDV, FDTD coef with its TDV, convection's lean
#: pseudo-transient cell (ten variant fields, k=3) and Jacobi5 on bfloat16
#: cells; with the p each pass runs.
EXTENDED_OPS = {"hotspot": 4, "probe_radius2": 2, "fdtd_coef": 2, "convection_pt_lean_f32": 2,
                "jacobi5_general__bf16": 4}
#: (i_start, offset, n) of a pass of p: every step active, 1 of p, none.
EXTENDED_STEPS = {"all": lambda p: (3, 3, 2 * p), "one": lambda p: (3 + p, 3, p + 1),
                  "none": lambda p: (3 + 2 * p, 3, 2 * p)}


def _extended_check(op, block, steps, seed, device):
    """One extended pass on ``block`` (``tile_sweep.extended_blocks``)
    through the kernel and its plain version: the largest difference, and
    the kernel's result with the block's geometry. Probe cells carry their
    global coordinates."""
    _, shape, origin, grid_range, stored = block
    p = EXTENDED_OPS[op]
    i_start, offset, n = EXTENDED_STEPS[steps](p)
    cell, tf, halo, tol = _case(op, shape, seed, device, iteration=i_start)
    if op in PROBES:
        cell = dataclasses.replace(cell, r=cell.r + origin[0], c=cell.c + origin[1])
    kw = dict(i_start=i_start, offset=offset, n_iterations=n, iters_per_pass=p, origin=origin,
              grid_range=grid_range, stored_halo=stored)
    before = tp.launches
    got = tp.tile_pass(cell, tf, halo, tile=(16, 32), **kw)
    want = tp.tile_pass_plain(cell, tf, halo, **kw)
    torch.cuda.synchronize()
    assert tp.launches == before + 1
    h, w = shape[0] - 2 * stored[0], shape[1] - 2 * stored[1]
    assert cell_leaves(got)[0].shape == (h, w)
    if op in PROBES:
        rows = torch.arange(h, device=device) + origin[0] + stored[0]
        cols = torch.arange(w, device=device) + origin[1] + stored[1]
        inside = (rows < grid_range[0])[:, None] & (cols < grid_range[1])[None, :] & (rows >= 0)[:, None] \
            & (cols >= 0)[None, :]
        assert bool((got.status[inside] == probe.NORMAL).all()), "probe cells flagged Invalid"
    return _max_err(got, want), tol


@pytest.mark.gpu
@pytest.mark.parametrize("steps", list(EXTENDED_STEPS))
@pytest.mark.parametrize("op", list(EXTENDED_OPS))
def test_extended_tile_pass_matches_plain_version(cuda, op, steps):
    """The nine shards of a 3x3 mesh (interior, edges, corners, negative
    origins, padding past the grid; cores 20x61, so block widths are odd;
    a stored halo wider than the pass's) and a ring chunk, exactly."""
    from stencilstream_tpu_torch.tile_sweep import extended_blocks

    _, tf, _, _ = _case(op, (2, 2), 0, "cpu")
    halo = tf.stencil_radius * EXTENDED_OPS[op] * tf.n_subiterations
    for seed, block in enumerate(extended_blocks((20, 61), halo)):
        err, _ = _extended_check(op, block, steps, seed, cuda)
        assert err == 0, (op, block, steps, err)


def _mesh(shape, device):
    from stencilstream_tpu_torch.parallel import make_mesh

    return make_mesh(shape=shape, devices=[device] * int(np.prod(shape)))


@pytest.mark.gpu
@pytest.mark.parametrize("backend,mesh_shape,kw", [
    ("distributed", (2, 2), {}),
    ("distributed", (4, 1), {"iters_per_pass": 8}),
    ("distributed", (1, 3), {"iters_per_pass": 3}),
    ("ring", (4,), {"iters_per_pass": 2, "chunk_rows": 48}),
], ids=["distributed-2x2", "distributed-4x1-p8", "distributed-1x3-p3", "ring4"])
def test_multi_device_hotspot_equals_tiling_on_one_card(cuda, backend, mesh_shape, kw):
    """HotSpot 300x260, n=13, on a mesh that names one card at every
    position: only the tile pass launches, the result equals `tiling`'s and
    the plain local compute's bit for bit, and `reference` within ATOL."""
    grid = Grid(_cell((300, 260), 3, cuda))
    mesh = _mesh(mesh_shape, cuda)
    before = (tp.launches, mt.launches, lc.launches)
    got, update = hs.run(grid, 13, backend=backend, mesh=mesh, **kw)
    launched = (tp.launches - before[0], mt.launches - before[1], lc.launches - before[2])
    assert launched[0] > 0 and launched[1:] == (0, 0)
    assert got.device == cuda
    want, _ = hs.run(grid, 13, backend="tiling")
    assert torch.equal(got.arrays.temp, want.arrays.temp)
    plain, _ = hs.run(grid, 13, backend=backend, mesh=mesh, local_compute="plain", **kw)
    assert torch.equal(got.arrays.temp, plain.arrays.temp)
    ref, _ = hs.run(grid, 13, backend="reference")
    assert float((got.arrays.temp - ref.arrays.temp).abs().max()) <= ATOL


@pytest.mark.gpu
@pytest.mark.parametrize("backend,kw", [("distributed", {"mesh_shape": (2, 2)}), ("ring", {"mesh_shape": (3,)})])
def test_multi_device_tdv_functors_on_one_card(cuda, backend, kw):
    """FDTD coef 64^2 (a TDV stream copied to each position's device) and
    the probe at radius 2, n=7 from 3, exactly as `reference`."""
    mesh = _mesh(kw["mesh_shape"], cuda)
    for op in ("fdtd_coef", "probe_radius2"):
        cell, tf, halo, _ = _case(op, (64, 64), 21, cuda, iteration=3)
        params = Params(tf, halo_value=halo, iteration_offset=3, n_iterations=7)
        got = create_update(params, backend=backend, mesh=mesh, iters_per_pass=2)(Grid(cell))
        want = create_update(params, backend="reference")(Grid(cell))
        assert _max_err(got.arrays, want.arrays) == 0, op
        if op == "probe_radius2":
            probe.check_probe_grid(got, 10)


@pytest.mark.gpu
@pytest.mark.parametrize("mesh_shape", [(4, 1), (2, 2)], ids=["4x1", "2x2"])
def test_resident_blocks_equal_tiling(cuda, mesh_shape):
    """Jacobi5 and HotSpot 520x300 as a BlockGrid on four cards where there
    are four, else on four positions of the one card: three chained calls of
    n = 21 at p = 8 equal one `tiling` call of 63 bit for bit, each call
    leaves its input alone and launches one tile pass a block a pass, and
    the blocks stay on their devices."""
    from stencilstream_tpu_torch import BlockGrid
    from stencilstream_tpu_torch.backends import distributed
    from stencilstream_tpu_torch.parallel import make_mesh

    devices = [torch.device("cuda", k) for k in range(4)] if torch.cuda.device_count() >= 4 else [cuda] * 4
    mesh = make_mesh(shape=mesh_shape, devices=devices)
    for op in ("jacobi5_general", "hotspot"):
        cell, tf, halo, _ = _case(op, (520, 300), 31, cuda)
        update = create_update(Params(tf, halo_value=halo, n_iterations=21, blocking=True), backend="distributed",
                               mesh=mesh, iters_per_pass=8)
        grid = BlockGrid.shard(Grid(cell), mesh.devices)
        first = [t.clone() for b in grid.cells() for t in cell_leaves(b)]
        before, exchanged = tp.launches, distributed.exchanges
        out = update(grid)
        assert tp.launches - before == 3 * 4 and distributed.exchanges - exchanged == 3
        assert all(torch.equal(a, b) for a, b in zip(first, [t for b in grid.cells() for t in cell_leaves(b)]))
        assert list(out.devices.flat) == list(mesh.devices.flat)
        out = update(update(out))
        want = create_update(Params(tf, halo_value=halo, n_iterations=63), backend="tiling")(Grid(cell))
        assert _max_err(out.gather(cuda).arrays, want.arrays) == 0, op


# -- the experiments/ microbenchmark kernels ----------------------------------
# csrc/micro_strip.cu (experiments/strip.py) and csrc/micro_linecache.cu
# (experiments/linecache.py): every variant equals its plain version exactly
# (the same float32 operations in the same order, the same fused
# multiply-adds); a NaN on both sides counts as equal, and the rows a
# *_noinit variant leaves undefined are not compared.


def _cu_variants(source, macro):
    """The argument lists of a source's variant list macro, as strings."""
    text = (cuda_lib.CSRC / source).read_text()
    body = text[text.index(f"#define {macro}(X)"):]
    body = body[: body.index("\n\n")]
    return [tuple(a.strip() for a in args.split(",")) for args in re.findall(r"X\(([^)]*)\)", body)]


def _cu_function_floats(source, function):
    """The hex float literals in one function of a source."""
    text = (cuda_lib.CSRC / source).read_text()
    body = text[text.index(function):]
    body = body[: body.index("\n}\n")]
    return {float.fromhex(h) for h in re.findall(r"(0x[0-9a-f.]+p[-+]?\d+)f", body)}


def test_micro_strip_variants_are_the_kernels_list():
    """csrc/micro_strip.cu lists strip.VARIANTS in order, with the same
    traits; its literal weights are the port's float32 constants."""
    updates = {"shifts": "kShifts", "center_first": "kCenterFirst", "center_last": "kCenterLast",
               "composite": "kComposite", "fma": "kFma", "shift_only": "kShiftOnly"}
    outs = {"edges": "kEdges", "shrink": "kShrink", "middle": "kMiddle"}
    masks = {"none": "kNone", "frame": "kFrame", "hoisted": "kHoisted", "inline": "kInline"}
    rows = _cu_variants("micro_strip.cu", "SS_MICRO_STRIP_VARIANTS")
    assert [r[1] for r in rows] == list(strip.VARIANTS)
    for k, (id_, name, p16, rw, cw, upd, fuse, out, mask, ca, ha, ne, rp) in enumerate(rows):
        v = strip.VARIANTS[name]
        assert int(id_) == k == strip.variant_id(name)
        assert (p16 == "true") == (16 in v.ps) and 8 in v.ps
        assert (rw, cw) == (str(v.rows_wrap).lower(), str(v.cols_wrap).lower()), name
        assert (upd, out, mask) == (updates[v.update], outs[v.out], masks[v.mask]), name
        assert int(fuse, 0) == sum(1 << j for j, f in enumerate(v.fused()) if f), name
        assert (ca, ha, int(ne), rp) == (str(v.coef_args).lower(), str(v.hv_arg).lower(), v.n_extra,
                                         str(v.row_pointer).lower()), name
    assert _cu_function_floats("micro_strip.cu", "constexpr float composite_weight") == {
        w for _, _, w in strip.COMPOSITE_TERMS}
    assert _cu_function_floats("micro_strip.cu", "constexpr float coef_literal") == set(strip.COEFS_F32)
    assert _cu_function_floats("micro_strip.cu", "constexpr float fma_scale") == {
        a for a, _ in strip.FMA_TERMS} - {1.0}
    assert _cu_function_floats("micro_strip.cu", "constexpr float fma_shift") == {b for _, b in strip.FMA_TERMS}


def test_micro_linecache_variants_are_the_kernels_list():
    """csrc/micro_linecache.cu lists linecache.VARIANTS in order, with the
    same traits; its literal weights are the port's float32 constants."""
    carries = {"first": "kFirst", "every": "kEvery", "none": "kNone"}
    rows = _cu_variants("micro_linecache.cu", "SS_MICRO_LINECACHE_VARIANTS")
    assert [r[1] for r in rows] == list(mlc.VARIANTS)
    for k, (id_, name, all_p, order, carry, layout, stitch, blocked) in enumerate(rows):
        v = mlc.VARIANTS[name]
        assert int(id_) == k == mlc.variant_id(name)
        assert (all_p == "true") == (v.ps == (8, 16, 32)) and 8 in v.ps
        assert (order, carry, layout) == ({"jacobi5": "kJacobi5", "bisect": "kBisect"}[v.order],
                                          carries[v.carry], f"k{v.layout}"), name
        assert (stitch, blocked) == (str(v.stitch).lower(), str(v.blocked).lower()), name
    assert _cu_function_floats("micro_linecache.cu", "float level_update") == set(mlc.LINECACHE_WEIGHTS) | set(
        mlc.BISECT_WEIGHTS)


#: (H, W, T): several strips, W not a whole number of 64-column tiles, and
#: two strips only (the first and the last).
STRIP_SHAPES = [(160, 130, 32), (256, 1000, 64), (64, 33, 32)]
#: (H, W, T, pad rows): W not a whole number of 128-column panels, several
#: segments with their warm-up (H > 512 rows), chunks of 16 rows (T=48),
#: pad rows not a whole strip (blocked variants then skip the shape).
LINECACHE_SHAPES = [(128, 130, 32, 40), (256, 1000, 64, 64), (1280, 70, 128, 32), (1056, 40, 48, 48)]


@pytest.mark.gpu
@pytest.mark.parametrize("variant,p", [(v, p) for v, s in strip.VARIANTS.items() for p in s.ps])
def test_micro_strip_kernel_matches_plain_version(cuda, variant, p):
    scalars = strip.StripScalars(coefs=(0.11, 0.21, 0.31, 0.41, 0.17), hv=0.5)
    for H, W, T in STRIP_SHAPES:
        if H < T + 2 * p:
            continue
        x = torch.tensor(np.random.default_rng(H + W).random((H, W), np.float32), device=cuda)
        before = strip.launches
        got = strip.strip_pass(x, variant, T=T, hp=p, p=p, scalars=scalars)
        assert strip.launches == before + 1
        want = strip.strip_pass_plain(x, variant, T=T, hp=p, p=p, scalars=scalars)
        assert torch.equal(got, want), (variant, p, H, W, T)


@pytest.mark.gpu
@pytest.mark.parametrize("variant,p", [(v, p) for v, s in mlc.VARIANTS.items() for p in s.ps])
def test_micro_linecache_kernel_matches_plain_version(cuda, variant, p):
    for H, W, T, pad in LINECACHE_SHAPES:
        if pad < p or (mlc.VARIANTS[variant].blocked and (H + pad) % T):
            continue
        x = torch.tensor(mlc.zero_pad(np.random.default_rng(H + W).random((H, W), np.float32), pad), device=cuda)
        skip = mlc.undefined_rows(variant, p)
        before = mlc.launches
        got = mlc.linecache_pass(x, variant, H=H, T=T, p=p)
        assert mlc.launches == before + 1
        want = mlc.linecache_pass_plain(x, variant, H=H, T=T, p=p)
        torch.testing.assert_close(got[skip:], want[skip:], rtol=0, atol=0, equal_nan=True,
                                   msg=f"{variant} p={p} {H}x{W} T={T}")
        alias = mlc.linecache_pass(x, variant, H=H, T=T, p=p, alias=True)
        assert torch.equal(alias[H:], x[H:]) and torch.equal(alias[skip:H], got[skip:H]), (variant, p, H, W, T)


@pytest.mark.gpu
def test_micro_kernels_refuse_a_p_they_are_not_built_for(cuda):
    x = torch.zeros(256, 64, device=cuda)
    with pytest.raises(NotImplementedError, match="built for p"):
        strip.strip_pass(x, "baseline", T=64, hp=16, p=16)
    with pytest.raises(NotImplementedError, match="built for p"):
        mlc.linecache_pass(torch.zeros(288, 64, device=cuda), "scratch3d", H=256, T=64, p=16)


def test_micro_wrappers_on_the_cpu_launch_nothing():
    x = torch.tensor(np.random.default_rng(0).random((96, 70), np.float32))
    xa = torch.tensor(mlc.zero_pad(np.random.default_rng(1).random((96, 70), np.float32), 8))
    before = (strip.launches, mlc.launches)
    assert torch.equal(strip.strip_pass(x, "concat", T=32, hp=8, p=8),
                       strip.strip_pass_plain(x, "concat", T=32, hp=8, p=8))
    torch.testing.assert_close(mlc.linecache_pass(xa, "lcs", H=96, T=32, p=8),
                               mlc.linecache_pass_plain(xa, "lcs", H=96, T=32, p=8), rtol=0, atol=0, equal_nan=True)
    assert (strip.launches, mlc.launches) == before
