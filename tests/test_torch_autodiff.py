"""Gradients through the PyTorch/CUDA port's ``reference`` backend against ``jax.grad``.

The JAX package's ``reference`` backend is differentiable with respect to
the initial state and to a transition function's parameters
(``tests/test_autodiff.py``); so is the port's: the same numpy inputs go
through ``jax.grad`` and ``torch.autograd``, and the gradients agree within
rtol 1e-5 (float32: both differentiate the same arithmetic, summed in
another order), and within rtol 2e-2 of a finite difference of step 1e-2,
as in the JAX test. The twins' fused multiply-adds (``core/fma.py``)
differentiate as ``a*b + c``. Every other backend runs the CUDA kernels,
which have no backward: it raises on a field or a parameter that requires
grad, on the CPU as on the card, and never returns a detached result.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencilstream_tpu import Grid as JGrid
from stencilstream_tpu import reference as jreference
from stencilstream_tpu.models import convection as jc
from stencilstream_tpu.models import hotspot as jh
from stencilstream_tpu.models import jacobi as jj

from stencilstream_tpu_torch import Grid, Params, create_update, interop, reference
from stencilstream_tpu_torch.core.fma import fma_f32, fma_f64
from stencilstream_tpu_torch.models import convection as pc
from stencilstream_tpu_torch.models import hotspot as ph
from stencilstream_tpu_torch.models import jacobi as pj

JACOBI5 = [0.15, 0.2, 0.25, 0.1, 0.3]
RTOL = 1e-5
FD_RTOL = 2e-2


def test_grad_wrt_initial_state_equals_jax():
    """``tests/test_autodiff.py``'s first case: d sum(x_4^2) / d x0 for
    Jacobi5 at 12x12, n=4, from ones."""
    jkernel = jj.make_kernel("jacobi5_general", JACOBI5)
    want = jax.grad(lambda x0: jnp.sum(jreference.apply_iterations(JGrid(x0), jkernel, 4).arrays ** 2))(
        jnp.ones((12, 12), jnp.float32))
    kernel = pj.make_kernel("jacobi5_general", JACOBI5)

    def loss(x0):
        return (reference.apply_iterations(Grid(x0), kernel, 4).arrays ** 2).sum()

    x0 = torch.ones(12, 12, requires_grad=True)
    loss(x0).backward()
    np.testing.assert_allclose(x0.grad.numpy(), np.asarray(want), rtol=RTOL)
    eps = 1e-2
    with torch.no_grad():
        bumped = torch.ones(12, 12)
        bumped[5, 5] += eps
        fd = float(loss(bumped) - loss(torch.ones(12, 12))) / eps
    np.testing.assert_allclose(float(x0.grad[5, 5]), fd, rtol=FD_RTOL)


def test_grad_wrt_kernel_parameter_equals_jax():
    """The second case: d sum(x_3) / d coef for Jacobi1 at 8x8, which is
    3 coef^2 sum(x0)."""
    def jloss(coef):
        out = jreference.apply_iterations(jj.init_grid(8, 8), jj.Jacobi1General(coef=coef), 3)
        return jnp.sum(out.arrays)

    want = float(jax.grad(jloss)(jnp.float32(0.5)))
    coef = torch.tensor(0.5, requires_grad=True)
    grid = pj.init_grid(8, 8, device="cpu")
    out = reference.apply_iterations(grid, pj.Jacobi1General(coef=coef), 3)
    assert out.arrays.requires_grad
    out.arrays.sum().backward()
    init_sum = float(grid.arrays.sum())
    np.testing.assert_allclose(float(coef.grad), want, rtol=RTOL)
    np.testing.assert_allclose(float(coef.grad), 3 * 0.25 * init_sum, rtol=RTOL)


@pytest.mark.parametrize("variant", ["jacobi4_general", "jacobi5_general", "jacobi9_general"])
def test_grad_wrt_every_coefficient_of_a_general_variant(variant):
    """Each coefficient of a general variant, given as a tensor, against
    ``jax.grad`` over the same coefficients; halo 0, random 10x11 grid."""
    n = pj.VARIANTS[variant].n_coefficients
    rng = np.random.default_rng(n)
    x0 = rng.random((10, 11), np.float32)
    coefs = rng.uniform(0.05, 0.3, n).astype(np.float32)

    def jkernel(c):
        if variant == "jacobi9_general":
            return jj.Jacobi9General(coef=tuple(c[i] for i in range(n)))
        return jj.VARIANTS[variant](**{f"c{i}": c[i] for i in range(n)})

    want = jax.grad(lambda c: jnp.sum(jreference.apply_iterations(JGrid(jnp.asarray(x0)), jkernel(c), 3).arrays ** 2))(
        jnp.asarray(coefs))
    c = torch.tensor(coefs, requires_grad=True)
    kernel = (pj.Jacobi9General(coef=tuple(c)) if variant == "jacobi9_general"
              else pj.VARIANTS[variant](**{f"c{i}": c[i] for i in range(n)}))
    out = reference.apply_iterations(Grid(torch.tensor(x0)), kernel, 3)
    (out.arrays ** 2).sum().backward()
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(want), rtol=RTOL)


def test_hotspot_grad_wrt_temperature_and_capacitance():
    """HotSpot, 3 iterations at 9x7 with random temperatures and powers:
    d sum(temp^2) / d temp0 and d / d Cap_1 against ``jax.grad``, and the
    capacitance's against a finite difference. The powers are large (50 to
    100), so that d temp / d Cap_1, the net heat flow into a cell, is not a
    small difference of large terms, whose float32 rounding would exceed
    the tolerance in either package."""
    rng = np.random.default_rng(11)
    temp0 = rng.uniform(70, 90, (9, 7)).astype(np.float32)
    power = rng.uniform(50, 100, (9, 7)).astype(np.float32)
    base = jh.derive_coefficients(9, 7)
    cap0 = np.float32(base.Cap_1) * np.float32(1e3)  # a step large enough to show

    def jloss(temp, cap):
        tf = dataclasses.replace(base, Cap_1=cap)
        out = jreference.apply_iterations(JGrid(jh.HotspotCell(temp=temp, power=jnp.asarray(power))), tf, 3,
                                          halo_value=jh.HotspotCell(temp=0.0, power=0.0))
        return jnp.sum(out.arrays.temp ** 2)

    want_temp, want_cap = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(temp0), jnp.float32(cap0))
    kernel = interop.hotspot_kernel(dataclasses.asdict(base))

    def loss(temp, cap, dtype=torch.float32):
        tf = dataclasses.replace(kernel, Cap_1=cap)
        out = reference.apply_iterations(Grid(ph.HotspotCell(temp=temp, power=torch.tensor(power))), tf, 3,
                                         halo_value=ph.HotspotCell(temp=0.0, power=0.0))
        return (out.arrays.temp.to(dtype) ** 2).sum()

    temp = torch.tensor(temp0, requires_grad=True)
    cap = torch.tensor(cap0, requires_grad=True)
    loss(temp, cap).backward()
    np.testing.assert_allclose(temp.grad.numpy(), np.asarray(want_temp), rtol=RTOL)
    np.testing.assert_allclose(float(cap.grad), float(want_cap), rtol=RTOL)
    # A step of a tenth of Cap_1: it moves the float32 temperatures by
    # ~1e-3, many ulps (7.6e-6 at 80); the loss is near linear in Cap_1.
    eps = np.float32(cap0 * np.float32(0.1))
    with torch.no_grad():
        up, down = (loss(torch.tensor(temp0), torch.tensor(cap0 + s * eps), torch.float64) for s in (1, -1))
    np.testing.assert_allclose(float(cap.grad), float(up - down) / float(2 * eps), rtol=FD_RTOL)


def test_convection_step_grad_wrt_vx():
    """One straight float32 pseudo-transient iteration on random fields
    (24x8, the JAX package's kernel and parameters): d sum of every field's
    square / d Vx against ``jax.grad``."""
    from test_convection import tiny_experiment

    e = tiny_experiment(res=8)
    rng = np.random.default_rng(12)
    shape = (e.nx + 1, e.ny + 1)
    fields = {f: rng.standard_normal(shape).astype(np.float32) for f in pc.FIELDS}
    jtf = jc.make_pseudo_transient_kernel(e, np.float32)

    def jloss(vx):
        cell = jc.ThermalConvectionCell(**{**{k: jnp.asarray(v) for k, v in fields.items()}, "Vx": vx})
        out = jreference.apply_iterations(JGrid(cell), jtf, 1, halo_value=jc.zero_cell())
        return sum(jnp.sum(getattr(out.arrays, f) ** 2) for f in pc.FIELDS)

    want = jax.grad(jloss)(jnp.asarray(fields["Vx"]))
    tf = interop.convection_pt_kernel(dataclasses.asdict(jtf))
    vx = torch.tensor(fields["Vx"], requires_grad=True)
    cell = pc.ThermalConvectionCell(**{**{k: torch.tensor(v) for k, v in fields.items()}, "Vx": vx})
    out = reference.apply_iterations(Grid(cell), tf, 1, halo_value=pc.zero_cell())
    sum((getattr(out.arrays, f).double() ** 2).sum() for f in pc.FIELDS).backward()
    got, want = vx.grad.numpy(), np.asarray(want)
    assert np.abs(got).max() > 0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("fma", [fma_f32, fma_f64], ids=["f32", "f64"])
def test_fused_multiply_adds_differentiate_as_a_times_b_plus_c(fma):
    """The twins' exact fused multiply-adds: d/da = b, d/db = a, d/dc = 1,
    also where float64's emulation scales tiny operands or returns ``c``."""
    dtype = torch.float32 if fma is fma_f32 else torch.float64
    a = torch.tensor([1.5, -2.25, 3e-30, 7.0], dtype=dtype, requires_grad=True)
    if dtype == torch.float64:
        a.data[2] = 1e-200  # the scaled path
    b = torch.tensor(0.3, dtype=dtype, requires_grad=True)
    c = torch.tensor([0.25, 1e30, -1.0, 2.0], dtype=dtype, requires_grad=True)
    fma(a, b, c).sum().backward()
    torch.testing.assert_close(a.grad, torch.full_like(a, 0.3), rtol=0, atol=0)
    torch.testing.assert_close(c.grad, torch.ones_like(c), rtol=0, atol=0)
    torch.testing.assert_close(b.grad, a.detach().sum(), rtol=1e-12, atol=0)


KERNEL_BACKENDS = [("tiling", {}), ("tiling", {"window_mode": "linecache"}), ("monotile", {}), ("auto", {})]


@pytest.mark.parametrize("backend,kw", KERNEL_BACKENDS, ids=lambda v: v if isinstance(v, str) else "-".join(v.values()))
def test_kernel_backends_raise_on_a_grid_that_requires_grad(backend, kw):
    kernel = pj.make_kernel("jacobi5_general", JACOBI5)
    x0 = torch.ones(12, 12, requires_grad=True)
    update = create_update(Params(transition_function=kernel, n_iterations=2), backend=backend, **kw)
    with pytest.raises(NotImplementedError, match="'reference'"):
        update(Grid(x0))
    coef = torch.tensor(0.5, requires_grad=True)
    update = create_update(Params(transition_function=pj.Jacobi1General(coef=coef), n_iterations=2), backend=backend,
                           **kw)
    with pytest.raises(NotImplementedError, match="parameter of Jacobi1General"):
        update(pj.init_grid(8, 8, device="cpu"))
    # Without grad, the same coefficient runs.
    update = create_update(Params(transition_function=pj.Jacobi1General(coef=coef.detach()), n_iterations=2),
                           backend=backend, **kw)
    np.testing.assert_array_equal(update(pj.init_grid(8, 8, device="cpu")).to_numpy(),
                                  pj.init_grid(8, 8, device="cpu").to_numpy() * np.float32(0.25))


def test_fdtd_grad_wrt_lut_table_equals_jax():
    """FDTD's lut resolver, 4 iterations on random fields of the tiny
    config: d (sum ex^2 + sum hz^2) / d the ``ca`` table against
    ``jax.grad``; the tables reach the update through ``resolver_state``."""
    from test_fdtd import tiny_config

    from stencilstream_tpu.models import fdtd as jf

    jp = jf.Parameters.from_json(tiny_config())
    jres = jf.LUTResolver(jp)
    jtf = jf.make_kernel(jp, jres)
    jarrays = jf.init_grid(jp, jres).arrays
    rng = np.random.default_rng(16)
    jarrays = dataclasses.replace(jarrays, **{
        f: jnp.asarray(rng.standard_normal(jarrays.ex.shape).astype(np.float32))
        for f in ("ex", "ey", "hz", "hz_sum")})
    ca0 = np.asarray(jtf.resolver_state["ca"])

    def jloss(ca):
        tf = dataclasses.replace(jtf, resolver_state={**jtf.resolver_state, "ca": ca})
        out = jreference.apply_iterations(JGrid(jarrays), tf, 4).arrays
        return jnp.sum(out.ex ** 2) + jnp.sum(out.hz ** 2)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(ca0)))
    tf = interop.fdtd_kernel("lut", {f.name: getattr(jtf, f.name) for f in dataclasses.fields(jtf)})
    ca = torch.tensor(ca0, requires_grad=True)
    tf = dataclasses.replace(tf, resolver_state={**tf.resolver_state, "ca": ca})
    grid = interop.fdtd_grid("lut", jax.tree_util.tree_map(np.asarray, jarrays), device="cpu")
    out = reference.apply_iterations(grid, tf, 4).arrays
    ((out.ex.double() ** 2).sum() + (out.hz.double() ** 2).sum()).backward()
    assert np.count_nonzero(want) > 0
    np.testing.assert_allclose(ca.grad.numpy(), want, rtol=RTOL)


@pytest.mark.parametrize("backend,kw", KERNEL_BACKENDS, ids=lambda v: v if isinstance(v, str) else "-".join(v.values()))
def test_kernel_backends_raise_on_a_table_that_requires_grad(backend, kw):
    """FDTD's lut resolver keeps its tables in a dict, ``resolver_state``:
    a table tensor that requires grad is a parameter too."""
    from test_fdtd import tiny_config

    from stencilstream_tpu_torch.models import fdtd as pf

    p = pf.Parameters.from_json(tiny_config())
    resolver = pf.LUTResolver(p)
    tf = pf.make_kernel(p, resolver)
    tf = dataclasses.replace(tf, resolver_state={
        **tf.resolver_state, "ca": torch.tensor(tf.resolver_state["ca"], requires_grad=True)})
    update = create_update(Params(transition_function=tf, n_iterations=2), backend=backend, **kw)
    with pytest.raises(NotImplementedError, match="parameter of FDTDKernel"):
        update(pf.init_grid(p, resolver, device="cpu"))


def test_kernel_backends_raise_on_a_wrapped_parameter_that_requires_grad():
    """A narrow-storage wrapper holds the transition function, which holds
    its coefficients in a tuple: three levels down, still found."""
    from stencilstream_tpu_torch.backends.storage_cast import CastStorageKernel, cast_storage

    coef = tuple(torch.tensor(c, requires_grad=(i == 4)) for i, c in enumerate(np.linspace(0.05, 0.13, 9)))
    tf = CastStorageKernel(pj.Jacobi9General(coef=coef))
    update = create_update(Params(transition_function=tf, n_iterations=2), backend="tiling")
    with pytest.raises(NotImplementedError, match="parameter of CastStorageKernel"):
        update(Grid(cast_storage(torch.ones(12, 12))))


@pytest.mark.parametrize("backend,kw", KERNEL_BACKENDS, ids=lambda v: v if isinstance(v, str) else "-".join(v.values()))
def test_kernel_backends_run_under_no_grad(backend, kw):
    """Under ``torch.no_grad()`` a detached result is what was asked for:
    the kernel backends run on a grid and a parameter that require grad,
    and give the reference's values."""
    x0 = torch.tensor(np.random.default_rng(15).random((12, 12), np.float32), requires_grad=True)
    tf = pj.Jacobi1General(coef=torch.tensor(0.5, requires_grad=True))
    with torch.no_grad():
        got = create_update(Params(transition_function=tf, n_iterations=3), backend=backend, **kw)(Grid(x0)).arrays
        want = reference.apply_iterations(Grid(x0), tf, 3).arrays
    assert not got.requires_grad
    assert torch.equal(got, want)


@pytest.mark.parametrize("backend", ["distributed", "ring"])
def test_multi_device_backends_raise_on_a_field_that_requires_grad(backend):
    from stencilstream_tpu_torch.parallel import make_mesh

    shape = (2, 2) if backend == "distributed" else (2,)
    mesh = make_mesh(shape=shape, devices=["cpu"] * int(np.prod(shape)))
    rng = np.random.default_rng(13)
    temp = torch.tensor(rng.uniform(70, 90, (16, 16)).astype(np.float32), requires_grad=True)
    cell = ph.HotspotCell(temp=temp, power=torch.zeros(16, 16))
    update = create_update(Params(transition_function=ph.derive_coefficients(16, 16), n_iterations=2,
                                  halo_value=ph.HotspotCell(temp=0.0, power=0.0)), backend=backend, mesh=mesh)
    with pytest.raises(NotImplementedError, match="field 'temp' requires grad"):
        update(Grid(cell))


def test_reference_gives_the_same_values_with_and_without_grad():
    kernel = pj.make_kernel("jacobi5_general", JACOBI5)
    x = torch.tensor(np.random.default_rng(14).random((9, 10), np.float32))
    plain = reference.apply_iterations(Grid(x), kernel, 5).arrays
    tracked = reference.apply_iterations(Grid(x.clone().requires_grad_()), kernel, 5).arrays
    assert tracked.requires_grad and not plain.requires_grad
    assert torch.equal(plain, tracked.detach())
